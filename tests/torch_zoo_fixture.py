"""Shared set-up of the port's ResNet-family and zoo parity tests: one JAX
variable tree, drawn from a seed, drives both packages through
``state_dict_from_jax``; reduced-depth trunks are swapped into both
packages' builder tables so that each structural option runs small. The
zoo's other trunks (``zoo_trunk_reference``) take the same draw, with
SwitchWhiten's running covariances made covariances and their residual
branches' last BN scales damped."""

from __future__ import annotations

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from mrfp_tpu.nn import resnet as jax_resnet
from mrfp_tpu.nn import seresnext as jax_seresnext
from mrfp_tpu_torch.nn import resnet as port_resnet
from mrfp_tpu_torch.nn import seresnext as port_seresnext

DAMP = 0.1

# family -> (the trunk name it stands in for, ResNet arguments but depth)
FAMILIES = {
    "basic": ("resnet-18", dict(block="basic")),
    "bottleneck": ("resnet-50", dict(block="bottleneck")),
    "grouped": ("resnext-50", dict(block="bottleneck", groups=32, base_width=4)),
    "wide": ("wide_resnet-50", dict(block="bottleneck", base_width=128)),
    "deep_stem": ("resnet-101", dict(block="bottleneck", deep_stem=True)),
}


def reduced_trunk(monkeypatch, family: str, layers=(1, 1, 1, 1)) -> str:
    """Make ``family``'s trunk name build at depth ``layers`` in both
    packages (the JAX MRFP's and zoo's builder tables, the port's
    ``_TRUNKS``) for this test; returns the name."""
    from mrfp_tpu.models import deepv3_zoo as jax_zoo
    from mrfp_tpu.models import mrfp as jax_mrfp
    trunk, kw = FAMILIES[family]
    build = functools.partial(jax_resnet.ResNet, layers=tuple(layers), **kw)
    monkeypatch.setitem(jax_mrfp._RESNET_BUILDERS, trunk, build)
    monkeypatch.setitem(jax_zoo._TRUNKS, trunk, dict(jax_zoo._TRUNKS[trunk], build=build))
    monkeypatch.setitem(port_resnet._TRUNKS, trunk, dict(kw, layers=tuple(layers)))
    return trunk


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def random_variables(module, x: np.ndarray, seed: int, damp: bool = False, **kw):
    """Random variables of ``module`` for input ``x`` as numpy trees
    ``(params, stats)``, drawn from ``seed`` into the shapes of
    ``jax.eval_shape`` of its ``init`` (no compute): conv kernels
    He-normal over their fan-in, conv biases 0.01-normal, each norm's
    scale 1 + 0.1-normal and bias 0.1-normal, running means 0.1-normal and
    variances |1 + 0.1-normal|. ``damp`` cuts each residual branch's last
    BN scale (``bn3``, or a BasicBlock's ``bn2``) to a tenth: the gradient
    checks' fixture (ROADMAP C3)."""
    shapes = jax.eval_shape(lambda: module.init({"params": jax.random.PRNGKey(0)},
                                                jnp.asarray(x), **kw))
    rng = np.random.default_rng(seed)

    def draw(path, shape):
        noise = rng.standard_normal(shape)
        if path[-1] == "kernel":
            val = noise * np.sqrt(2.0 / np.prod(shape[:-1]))
        elif path[-1] == "scale" or path[-1] == "var":
            val = np.abs(1.0 + 0.1 * noise) if path[-1] == "var" else 1.0 + 0.1 * noise
        elif path[-1] == "bias" and "kernel" in _node(shapes["params"], path[1:-1]):
            val = 0.01 * noise
        else:  # a norm's bias, a running mean
            val = 0.1 * noise
        return val.astype(np.float32)

    trees = {}
    for coll in ("params", "batch_stats"):
        trees[coll] = tree = _plain(shapes.get(coll, {}))
        for path, a in list(_walk(tree)):
            _set(tree, path, draw((coll,) + path, a.shape))
    params, stats = trees["params"], trees["batch_stats"]
    if damp:
        for path, a in list(_walk(params)):
            if path[-1] == "scale" and _is_last_bn(params, path):
                _set(params, path, a * DAMP)
    return params, stats


def _plain(tree):
    """A nested dict copy of a (frozen) variable tree."""
    return {k: _plain(v) if hasattr(v, "items") else v for k, v in tree.items()}


def _node(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _is_last_bn(params, path) -> bool:
    """Whether ``path`` is the last BN of a residual branch: ``bn3``, or
    ``bn2`` in a block without ``conv3``."""
    if len(path) < 3 or not path[-3].startswith("block"):
        return False
    block = _node(params, path[:-2])
    return path[-2] == ("bn3" if "conv3" in block else "bn2")


def jax_vars(params, stats):
    return {"params": jax.tree_util.tree_map(jnp.asarray, params),
            "batch_stats": jax.tree_util.tree_map(jnp.asarray, stats)}


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.transpose(np.asarray(a), (0, 3, 1, 2)).copy())


def nhwc(t: torch.Tensor) -> np.ndarray:
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def spd_running_cov(stats, seed: int = 0):
    """Every SwitchWhiten ``running_cov`` of a drawn tree made a covariance
    (the identity plus a small SPD term): ``random_variables``' 0.1-normal
    draw has no inverse square root."""
    rng = np.random.default_rng(seed)
    for path, a in list(_walk(stats)):
        if path[-1] == "running_cov":
            m = 0.3 * rng.standard_normal(a.shape)
            _set(stats, path, (np.eye(a.shape[-1]) + m @ m.transpose(0, 2, 1) / a.shape[-1])
                 .astype(np.float32))
    return stats


# each residual branch's last BN in the zoo's other trunks: MobileNetV2's
# project_bn, MNASNet's pw_linear, SE-ResNeXt's bn3
_LAST_BN = ("project_bn", "pw_linear", "bn3")


def damp_last_bns(params):
    """Those BN scales times ``DAMP`` (ROADMAP C3's fixture)."""
    for path, a in list(_walk(params)):
        if path[-1] == "scale" and any(p in _LAST_BN for p in path[-3:-1]):
            _set(params, path, a * DAMP)
    return params


# trunk -> (variant, wt_layer, whether the step takes the whitening loss):
# every iw code where the trunk has slots, D, D16 and dilation both ways
ZOO_TRUNK_CASES = {
    "mobilenetv2": ("D16", (0, 0, 2, 5, 2, 4, 0), True),
    "shufflenetv2": ("D", (0, 0, 3, 2, 4, 5, 2), True),
    "mnasnet_05": ("D16", (0,) * 7, False),
    "mnasnet_10": ("D", (0,) * 7, False),
    "se_resnext-50": ("D16", (0,) * 7, False),
    "se_resnext-101": ("D16", (0,) * 7, False),
}


def zoo_trunk_reference(monkeypatch, trunk: str, hw: int, seed: int = 12):
    """``(variant, wt, use_wtloss, JAX DeepV3Plus, params, stats)`` of
    ``trunk``'s case with the DSN head, on the damped fixture.
    SE-ResNeXt-101 is cut to depth (1, 1, 2, 1) in both packages' tables."""
    from mrfp_tpu.models import deepv3_zoo as jax_zoo
    from mrfp_tpu_torch.models import deepv3_zoo as port_zoo
    if trunk == "se_resnext-101":
        build = functools.partial(jax_seresnext.SENet, layers=(1, 1, 2, 1), kind="seresnext",
                                  groups=32)
        monkeypatch.setitem(jax_zoo._TRUNKS, trunk, dict(jax_zoo._TRUNKS[trunk], build=build))
        monkeypatch.setitem(port_zoo.ZOO_TRUNKS, trunk, lambda wt, variant: port_seresnext.SENet(
            layers=(1, 1, 2, 1), kind="seresnext", groups=32))
    variant, wt, wtloss = ZOO_TRUNK_CASES[trunk]
    jmodel = jax_zoo.DeepV3Plus(trunk=trunk, variant=variant, wt_layer=wt, use_dsn=True)
    params, stats = random_variables(jmodel, np.zeros((1, hw, hw, 3), np.float32), seed=seed,
                                     train=False)
    return variant, wt, wtloss, jmodel, damp_last_bns(params), spd_running_cov(stats)
