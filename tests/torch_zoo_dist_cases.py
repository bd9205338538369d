"""The cases of tests/test_torch_zoo_dist.py and tests/test_torch_plan.py,
in the port alone (no jax): each runs in one process on a whole batch, or
in each rank of a process group (``torch_dist_group.Group``) on that
rank's rows of it, with the same code."""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from mrfp_tpu_torch.core.config import Config
from mrfp_tpu_torch.models.deepv3_zoo import DeepV3Plus, build_cov_layers
from mrfp_tpu_torch.nn.norms import GlobalBatchNorm2d, SwitchWhiten2d
from mrfp_tpu_torch.parallel.audit import count_collectives
from mrfp_tpu_torch.parallel.dist import rank, world
from mrfp_tpu_torch.train.state import create_train_state
from mrfp_tpu_torch.train.zoo_step import covstat_pass, zoo_train_step

from torch_dist_cases import digest, rows  # noqa: F401  (digest: the tests')

# the zoo step of the 2-rank tests: r18-D32, ISW in slots 2-3 and
# SwitchWhiten in slot 4, the whitening loss, the DSN head
TRUNK, VARIANT, WT = "resnet-18", "D32", (0, 0, 2, 2, 5, 0, 0)


def sw_case(x: torch.Tensor, dy: torch.Tensor, sw_type: int, sd: dict) -> dict:
    """One train-mode forward and backward (``(out * dy).sum()``) of
    ``SwitchWhiten2d(sw_type)`` with the state ``sd`` on this process's
    rows of ``x``, in ``x``'s dtype (fp64 through the layer's ``_whiten``,
    which the module's fp32 forward wraps). The parameters' gradients are
    this process's part."""
    sw = SwitchWhiten2d(x.shape[1], sw_type)
    sw.load_state_dict(sd)
    sw.to(x.dtype).train()
    xr = x[rows(x.shape[0])].clone().requires_grad_(True)
    out = sw(xr) if x.dtype == torch.float32 else sw._whiten(xr)
    (out * dy[rows(x.shape[0])]).sum().backward()
    return {"out": out.detach(), "dx": xr.grad,
            **{f"d_{k}": p.grad for k, p in sw.named_parameters()},
            "running_mean": sw.running_mean, "running_cov": sw.running_cov}


def zoo_cfg(use_wtloss: bool = True) -> Config:
    """The fp32 zoo recipe at rate 1 (the JAX gradient reads back from its
    update)."""
    cfg = Config()
    return cfg.replace(model=dataclasses.replace(cfg.model, trunk=TRUNK, variant=VARIANT,
                                                 wt_layer=WT, use_wtloss=use_wtloss),
                       train=dataclasses.replace(cfg.train, lr=1.0, compute_dtype="float32"))


def zoo_model(sd: dict) -> DeepV3Plus:
    model = DeepV3Plus(trunk=TRUNK, variant=VARIANT, wt_layer=WT, use_dsn=True)
    model.load_state_dict(sd, strict=True)
    return model


def zoo_step_case(sd: dict, img: torch.Tensor, lbl: torch.Tensor, masks: list, nrc: list,
                  keep: torch.Tensor) -> dict:
    """One fp32 zoo step from the state ``sd`` on this process's rows of
    the batch, with the whitening masks and the DSN keep mask of the
    global batch (its rows here). Returns the losses, every gradient and
    the state after the step."""
    model = zoo_model(sd)
    state = create_train_state(model, zoo_cfg().train)
    r = rows(img.shape[0])
    m = zoo_train_step(state, img[r].contiguous(), lbl[r].contiguous(), zoo_cfg(), masks, nrc,
                       dropout=keep[r].contiguous())
    return {"losses": {k: float(v) for k, v in m.items() if k.startswith("loss")},
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def covstat_case(sd: dict, pairs: list) -> dict:
    """The statistics pass over ``pairs`` (tensors; every rank the same
    ones, at the local batch): the masks and counts, rank 0's on every
    rank."""
    layers = build_cov_layers(TRUNK, WT, clusters=5)
    pairs = [tuple(v.numpy() for v in pair) for pair in pairs]
    masks, nrc = covstat_pass(zoo_model(sd), layers, pairs, zoo_cfg(), torch.device("cpu"))
    return {"masks": masks, "nrc": nrc}


@contextlib.contextmanager
def module_counts(model):
    """What ``model``'s own modules imply of a step's collectives while
    open, in the yielded dict: its train-mode forwards of the global
    BatchNorm (``bn``; the OC branch's functional ones too, which its
    stages run through ``ops/oc_stage.py``) and of SwitchWhiten (``sw``),
    and NP+'s gathered means (``gathers``); each pays one ``all_reduce``
    forward and one backward."""
    from mrfp_tpu_torch.ops import oc_stage
    from mrfp_tpu_torch.perturb import np_plus
    seen = {"bn": 0, "sw": 0, "gathers": 0}

    def hook(kind):
        def count(module, _inp, _out):
            seen[kind] += int(module.training)
        return count

    handles = [m.register_forward_hook(hook("bn" if isinstance(m, GlobalBatchNorm2d) else "sw"))
               for m in model.modules() if isinstance(m, (GlobalBatchNorm2d, SwitchWhiten2d))]
    patched = [(np_plus, "all_gather_rows", "gathers"), (oc_stage, "batch_norm_train", "bn")]
    originals = [getattr(mod, name) for mod, name, _ in patched]

    def counting(fn, kind):
        def call(*args, **kwargs):
            seen[kind] += 1
            return fn(*args, **kwargs)
        return call

    for (mod, name, kind), fn in zip(patched, originals):
        setattr(mod, name, counting(fn, kind))
    try:
        yield seen
    finally:
        for (mod, name, _), fn in zip(patched, originals):
            setattr(mod, name, fn)
        for h in handles:
            h.remove()


def _audited(model, step) -> dict:
    with module_counts(model) as seen, count_collectives() as log:
        step()
    return {"log": [(c.op, c.dtype, c.bytes) for c in log], "seen": seen,
            "grad_dtypes": len({p.dtype for p in model.parameters() if p.requires_grad})}


def audited_step_case(argv: list) -> dict:
    """One step of ``cli.plan``'s rank on this process's rows (the plan's
    flags ``argv``, its config and batch), under ``parallel/audit.py``'s
    count, beside ``module_counts``."""
    from mrfp_tpu_torch.cli import plan
    from mrfp_tpu_torch.cli.train import build_state
    from mrfp_tpu_torch.train.step import train_step
    args = plan.parse_args(argv)
    cfg = plan.train_config(args, args.crop_size)
    state = build_state(cfg, torch.device("cpu"))
    img, lbl = plan.step_batch(world(), rank(), args.batch_size, args.crop_size, "cpu")
    return _audited(state.model, lambda: train_step(state, img, lbl, cfg))


def audited_zoo_step_case(sd: dict, img: torch.Tensor, lbl: torch.Tensor, masks: list,
                          nrc: list) -> dict:
    """``zoo_step_case``'s step (its dropout drawn) under the count."""
    model = zoo_model(sd)
    state = create_train_state(model, zoo_cfg().train)
    r = rows(img.shape[0])
    return _audited(model, lambda: zoo_train_step(state, img[r].contiguous(),
                                                  lbl[r].contiguous(), zoo_cfg(), masks, nrc))


def view_pairs(n_pairs: int, batch: int, hw: int, seed: int = 9) -> list:
    """Seeded fp32 NHWC view pairs of the statistics pass."""
    rng = np.random.default_rng(seed)
    return [tuple(rng.uniform(0, 255, (batch, hw, hw, 3)).astype(np.float32) for _ in range(2))
            for _ in range(n_pairs)]
