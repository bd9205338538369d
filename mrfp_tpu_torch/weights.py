"""Weights for the port: from the JAX variable tree, or from a reference .pth.

The port keeps the reference's state_dict key layout, so both reduce to
``load_state_dict(strict=True)``:

- ``state_dict_from_jax`` maps the JAX ``MRFP`` or zoo ``DeepV3Plus`` tree
  over any trunk of the zoo (nested dicts of numpy arrays; no JAX import;
  with ``use_dsn`` its ``dsn`` head too) to the port's keys, as
  mrfp_tpu/train/export_torch.py::export_state_dict does for the reference:
  conv kernels HWIO -> OIHW (a depthwise (kh, kw, 1, C) -> (C, 1, kh, kw)),
  BN scale/bias/mean/var -> weight/bias/running_mean/running_var,
  ``num_batches_tracked`` = 0, SwitchWhiten's leaves by their own names.
  The ResNets keep the reference's keys; the other trunks name their
  modules after the JAX tree under ``layer0``..``layer4``
  (``tree_state_from_jax``), and no reference ``.pth`` of them loads in
  either package (ROADMAP C13).
- ``oc_state_from_jax`` maps the JAX OC tree (``enc1..dec4`` with
  ``kernel`` HWIO, ``bias``, ``bn_scale``, ``bn_bias``;
  mrfp_tpu/train/import_torch.py:26-33) to the port's OC buffers under the
  reference's names (``OClayer1``, ``OC1_bn``, ...).
- ``load_torch_checkpoint`` reads the reference's on-disk container
  ``{'epoch', 'state_dict'}`` (keys ``module.``-prefixed by DataParallel),
  or a checkpoint of the port's trainer (its ``model`` entry), and drops the
  train-only OC-branch tensors, which the eval forward never reads, and the
  DSN head's for a model built without it (a ``--use-dsn`` run evaluated by
  ``cli.eval``). ``train_state_dict`` keeps the OC tensors for a model with
  OC buffers.
"""

from __future__ import annotations

import hashlib
import logging
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mrfp_tpu_torch.core.mesh import Mesh, state_placement
from mrfp_tpu_torch.nn import mnasnet, mobilenet, seresnext, shufflenet
from mrfp_tpu_torch.parallel.dist import gather_rows
from mrfp_tpu_torch.perturb.oc_branch import REF_NAMES

_STAGE_OF = (mobilenet.stage_of, shufflenet.stage_of, mnasnet.stage_of, seresnext.stage_of)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _conv(sd: dict, ref: str, node: Dict[str, Any]) -> None:
    sd[f"{ref}.weight"] = _t(np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1)))
    if "bias" in node:
        sd[f"{ref}.bias"] = _t(node["bias"])


def _norm(sd: dict, ref: str, node: Dict[str, Any],
          stats: Optional[Dict[str, Any]]) -> None:
    """BatchNorm (with stats), affine InstanceNorm (without), or
    SwitchWhiten (its weights and its running mean and covariance)."""
    sd[f"{ref}.weight"] = _t(node["scale"])
    sd[f"{ref}.bias"] = _t(node["bias"])
    for k in ("sw_mean_weight", "sw_var_weight"):
        if k in node:
            sd[f"{ref}.{k}"] = _t(node[k])
    if stats and "mean" in stats:
        sd[f"{ref}.running_mean"] = _t(stats["mean"])
        sd[f"{ref}.running_var"] = _t(stats["var"])
        sd[f"{ref}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    for k in ("running_mean", "running_cov"):
        if stats and k in stats:
            sd[f"{ref}.{k}"] = _t(stats[k])


def _conv_bn(sd: dict, ref: str, node: dict, stats: dict) -> None:
    """A JAX ConvBNReLU {conv, bn} -> Sequential children ``.0``/``.1``."""
    _conv(sd, f"{ref}.0", node["conv"])
    _norm(sd, f"{ref}.1", node["bn"], stats.get("bn"))


def state_dict_from_jax(params: Dict[str, Any],
                        batch_stats: Optional[Dict[str, Any]] = None
                        ) -> Dict[str, torch.Tensor]:
    """JAX ``MRFP`` or zoo ``DeepV3Plus`` variables -> the port's state_dict.
    A trunk other than a ResNet maps path for path (``backbone_state_from_jax``).
    A ResNet's map is the inverse of the key map of
    mrfp_tpu/train/import_torch.py:98-278. The stem is ``conv1`` and its norm
    (``bn1``, or ``bn1_iw`` for an affine IN or SwitchWhiten) at ``layer0.0/1``; the deep
    stem of resnet-101 adds ``conv2``/``conv3`` and their norms at
    ``layer0.3/4`` and ``layer0.6/7``. A block maps ``conv1..3``/``bn1..3``
    (a BasicBlock has two of each), the downsample pair and an affine
    IN's or SwitchWhiten's ``instance_norm_layer``; iw codes 1-3 have no variables. Grouped
    kernels keep their HWIO per-group layout, which transposes to torch's
    ``(out, in / groups, kh, kw)``."""
    stats = batch_stats or {}
    sd = backbone_state_from_jax(params["backbone"], stats.get("backbone"))
    ap, ast = params["aspp"], stats.get("aspp", {})
    for name in ap:
        ref = "aspp.img_conv" if name == "img_conv" else \
            f"aspp.features.{int(name[len('feat'):])}"
        _conv_bn(sd, ref, ap[name], ast.get(name, {}))
    dp, dst = params["decoder"], stats.get("decoder", {})
    for name, ref in (("bot_fine", "bot_fine"), ("bot_aspp", "bot_aspp")):
        _conv_bn(sd, ref, dp[name], dst.get(name, {}))
    for name, j in (("final1_0", 0), ("final1_1", 3)):
        _conv(sd, f"final1.{j}", dp[name]["conv"])
        _norm(sd, f"final1.{j + 1}", dp[name]["bn"], dst.get(name, {}).get("bn"))
    _conv(sd, "final2.0", params["final2"])
    if "dsn" in params:  # the DSN head's Sequential: 0 conv, 1 BN, 4 classifier
        dsn, dst = params["dsn"], stats.get("dsn", {})
        _conv_bn(sd, "dsn", dsn["conv"], dst.get("conv", {}))
        _conv(sd, "dsn.4", dsn["classifier"])
    return sd


def backbone_state_from_jax(bp: Dict[str, Any], bst: Optional[Dict[str, Any]] = None
                            ) -> Dict[str, torch.Tensor]:
    """A JAX trunk's variables -> ``layer0``..``layer4`` of the port's
    state_dict (``state_dict_from_jax`` says how): a ResNet (its tree has
    ``layer1``) by the reference's keys, any other trunk by
    ``tree_state_from_jax`` under the layer ``zoo_layer`` gives each of its
    top-level modules."""
    bst = bst or {}
    sd: Dict[str, torch.Tensor] = {}
    if "layer1" not in bp:
        for name in bp:
            k = zoo_layer(name)
            sd.update(tree_state_from_jax(bp[name], bst.get(name), f"layer{k}.{name}."))
        return sd
    for i in (1, 2, 3) if "conv2" in bp else (1,):
        _conv(sd, f"layer0.{3 * (i - 1)}", bp[f"conv{i}"])
        for name in (f"bn{i}", f"bn{i}_iw"):
            if name in bp:
                _norm(sd, f"layer0.{3 * (i - 1) + 1}", bp[name], bst.get(name))
    for L in (1, 2, 3, 4):
        lyr, lst = bp[f"layer{L}"], bst.get(f"layer{L}", {})
        for blk in sorted(lyr, key=lambda n: int(re.sub(r"\D", "", n))):
            ref = f"layer{L}.{int(blk[len('block'):])}"
            for k, v in block_state_from_jax(lyr[blk], lst.get(blk, {})).items():
                sd[f"{ref}.{k}"] = v
    return sd


def block_state_from_jax(b: Dict[str, Any], bs: Optional[Dict[str, Any]] = None
                         ) -> Dict[str, torch.Tensor]:
    """One JAX ``BasicBlock`` or ``Bottleneck``'s variables -> the port
    block's state_dict (keys relative to the block)."""
    bs = bs or {}
    sd: Dict[str, torch.Tensor] = {}
    for i in (1, 2, 3):
        if f"conv{i}" in b:
            _conv(sd, f"conv{i}", b[f"conv{i}"])
            _norm(sd, f"bn{i}", b[f"bn{i}"], bs.get(f"bn{i}"))
    if "downsample_conv" in b:
        _conv(sd, "downsample.0", b["downsample_conv"])
        _norm(sd, "downsample.1", b["downsample_bn"], bs.get("downsample_bn"))
    if "instance_norm_layer" in b:
        _norm(sd, "instance_norm_layer", b["instance_norm_layer"], bs.get("instance_norm_layer"))
    return sd


def zoo_layer(name: str) -> int:
    """The stage (0-4) whose ``layer<k>`` holds a non-ResNet trunk's
    top-level JAX module ``name``: the ``stage_of`` of the trunk module
    that builds it, the one its constructor groups by."""
    for stage_of in _STAGE_OF:
        k = stage_of(name)
        if k is not None:
            return k
    raise ValueError(f"no stage for the JAX trunk module {name!r}")


def tree_state_from_jax(params: Dict[str, Any], stats: Optional[Dict[str, Any]] = None,
                        prefix: str = "") -> Dict[str, torch.Tensor]:
    """A JAX module tree -> the state_dict of a port module whose children
    bear the JAX names, path for path under ``prefix``: a conv node
    (``kernel``, ``bias``) to ``weight`` (OIHW) and ``bias``, a norm node
    (``scale``, ...) as ``_norm`` maps it with the stats at the same path."""
    stats = stats or {}
    sd: Dict[str, torch.Tensor] = {}
    if "kernel" in params:
        _conv(sd, prefix[:-1], params)
    elif "scale" in params:
        _norm(sd, prefix[:-1], params, stats)
    for name, node in params.items():
        if isinstance(node, dict) or hasattr(node, "items"):
            sd.update(tree_state_from_jax(node, stats.get(name), f"{prefix}{name}."))
    return sd


def oc_state_from_jax(oc_params: Dict[str, Dict[str, Any]]) -> Dict[str, torch.Tensor]:
    """JAX OC tree -> the port's OC buffers (reference names)."""
    sd: Dict[str, torch.Tensor] = {}
    for stage, (conv, bn) in REF_NAMES.items():
        node = oc_params[stage]
        _conv(sd, conv, node)
        sd[f"{bn}.weight"] = _t(node["bn_scale"])
        sd[f"{bn}.bias"] = _t(node["bn_bias"])
    return sd


def _is_oc_key(key: str) -> bool:
    """OClayerK / OCdeclayerK / OCK_bn / OCK_decbn (deepv3.py:221-237)."""
    return key.split(".", 1)[0].startswith("OC")


def eval_state_dict(sd: Dict[str, torch.Tensor]
                    ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A reference state_dict -> (the port's eval state_dict, dropped OC
    keys): strips DataParallel's ``module.`` and drops the OC branch."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    dropped = sorted(k for k in sd if _is_oc_key(k))
    return {k: v for k, v in sd.items() if not _is_oc_key(k)}, dropped


def train_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference state_dict -> the state_dict of a model with OC buffers:
    strips ``module.`` and keeps the OC convs and BN affines, dropping the
    OC BNs' running statistics, which train-mode BN never reads (the JAX
    importer consumes them unused, mrfp_tpu/train/import_torch.py:133-135)."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    return {k: v for k, v in sd.items()
            if not (_is_oc_key(k) and k.rsplit(".", 1)[-1] in
                    ("running_mean", "running_var", "num_batches_tracked"))}


def load_torch_checkpoint(model: nn.Module, path: str) -> Dict[str, Any]:
    """Load a reference .pth (``{'epoch', 'state_dict'}`` or a bare
    state_dict), or a ``step_<N>.pt`` of the port's trainer (its ``model``
    state_dict), into ``model`` strictly; returns a report. The DSN head's
    tensors are dropped, and reported, when ``model`` has no head."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob["model"] if "model" in blob else blob.get("state_dict", blob)
    sd, dropped = eval_state_dict(sd)
    if not getattr(model, "use_dsn", False):
        dsn = sorted(k for k in sd if k.startswith("dsn."))
        sd = {k: v for k, v in sd.items() if not k.startswith("dsn.")}
        dropped = dropped + dsn
    model.load_state_dict(sd, strict=True)
    logging.getLogger(__name__).info(
        "loaded %d tensors from %s; dropped %d train-only OC-branch and DSN tensors",
        len(sd), path, len(dropped))
    return {"loaded": len(sd), "dropped": dropped}


# the OC modules, whole on every rank of a model group (JAX's oc_params)
OC_MODULES = tuple(name for pair in REF_NAMES.values() for name in pair)


def tp_placement(sd: Dict[str, torch.Tensor], mp: int) -> Dict[str, Optional[int]]:
    """The dim each entry of a whole state_dict shards over ``mp`` ranks,
    or None: ``core.mesh.state_placement`` with the OC buffers whole."""
    return state_placement(sd, mp, OC_MODULES)


def _own(t: torch.Tensor, dim: Optional[int], mesh: Mesh) -> torch.Tensor:
    if dim is None:
        return t
    return t.chunk(mesh.mp, dim)[mesh.model_index].clone()


def shard_state_dict(sd: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """A whole state_dict in the reference key layout -> this rank's
    shards (JAX's ``shard_state``): each tensor ``tp_placement`` shards is
    cut into ``mesh.mp`` equal slices along its dim and this rank keeps
    slice ``mesh.model_index``; the rest stays as it is."""
    if mesh.mp == 1:
        return dict(sd)
    place = tp_placement(sd, mesh.mp)
    return {k: _own(v, place[k], mesh) for k, v in sd.items()}


def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Cut the whole ``model`` down, in place, to this rank's shards of
    ``shard_state_dict``: each sharded parameter and buffer is replaced by
    its slice. A conv whose kernel is sharded computes its slice of output
    channels (``tp_sharded``; a grouped conv takes ``groups / M`` groups of
    its own input slice, ``tp_local``); a conv whose kernel M does not
    divide stays whole and computes its whole map on every rank (JAX's
    rule keeps such a kernel whole too: ShuffleNetV2's 58-channel branch
    convs at M = 4, the classifiers). Each norm keeps the channels of its
    own placement: an affine or tracking norm those of its tensors, a
    norm without tensors those of the map its width makes, sliced where M
    divides it (``tp_spec``'s rule for its per-channel vector). Raises for
    a grouped conv whose kernel shards but whose groups M does not divide.
    The model keeps the sharded keys in ``tp_keys``. A model at ``mp == 1``
    is returned as it is."""
    if mesh.mp == 1:
        return model
    mp = mesh.mp
    place = tp_placement(model.state_dict(), mp)
    for name, module in model.named_modules():
        prefix = f"{name}." if name else ""
        conv = isinstance(module, nn.Conv2d) and not prefix.startswith(OC_MODULES)
        sharded = conv and place[prefix + "weight"] is not None
        if sharded and module.groups > 1 and module.groups % mp:
            raise ValueError(
                f"--model-parallel {mp}: {name} has {module.out_channels} output channels in "
                f"{module.groups} groups; its kernel shards over M but its groups do not "
                f"divide by M")
        for kind in ("_parameters", "_buffers"):
            for attr, t in list(getattr(module, kind).items()):
                dim = None if t is None else place[prefix + attr]
                if dim is None:
                    continue
                part = _own(t.detach(), dim, mesh)
                getattr(module, kind)[attr] = (nn.Parameter(part, t.requires_grad)
                                               if kind == "_parameters" else part)
        if sharded:
            module.out_channels //= mp
            module.tp_sharded = True
            if module.groups > 1:
                module.groups //= mp
                module.in_channels //= mp
                module.tp_local = True
        elif isinstance(module, (nn.BatchNorm2d, nn.InstanceNorm2d)):
            held = module.weight if module.weight is not None else module.running_mean
            if held is not None:
                module.num_features = held.shape[0]
            elif module.num_features % mp == 0:
                module.num_features //= mp
    model.tp_keys = frozenset(k for k, dim in place.items() if dim is not None)
    return model


def replicated_digest(model: nn.Module) -> str:
    """The sha256 of every state_dict entry that ``shard_model`` left whole
    (all of them for a model it did not cut), in key order: the ranks of a
    model group hold these bit for bit the same, or they drift apart."""
    h = hashlib.sha256()
    keys = getattr(model, "tp_keys", frozenset())
    for k, v in sorted(model.state_dict().items()):
        if k not in keys:
            h.update(k.encode())
            h.update(v.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy())
    return h.hexdigest()


def whole_state_dict(model: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The whole state_dict of a model ``shard_model`` cut, on every rank
    of its model group: each sharded tensor's slices gathered in rank
    order (one ``all_reduce`` a tensor, over the model group: every rank
    must call it). ``model.state_dict()`` itself at ``mp == 1``."""
    sd = model.state_dict()
    keys = getattr(model, "tp_keys", frozenset())
    if mesh.mp == 1 or not keys:
        return sd
    return {k: gather_rows(v, mesh.model) if k in keys else v for k, v in sd.items()}
