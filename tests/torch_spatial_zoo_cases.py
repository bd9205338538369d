"""The cases of tests/test_torch_spatial_zoo.py, in the port alone (no jax):
each runs in every rank of a process group (``torch_dist_group.Group``) on
that rank's band of rows, or in the test process on the whole map, with
the same code. A case of a spatial group of ``sp`` ranks runs on ranks
``0..sp-1`` of the world; the others return ``{"skip": True}``."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from mrfp_tpu_torch.core.config import Config, MeshConfig
from mrfp_tpu_torch.core.mesh import bands, create_mesh, reset_mesh, shard_batch
from mrfp_tpu_torch.models.deepv3_zoo import (DeepV3Plus, build_cov_layers,
                                              covariance_variance)
from mrfp_tpu_torch.models import deepv3_zoo
from mrfp_tpu_torch.nn import seresnext as port_seresnext
from mrfp_tpu_torch.nn.layers import MaxPool2d
from mrfp_tpu_torch.nn.norms import SwitchWhiten2d
from mrfp_tpu_torch.nn.seresnext import SEBottleneckBlock
from mrfp_tpu_torch.parallel import dist
from mrfp_tpu_torch.parallel.audit import count_collectives, summarize_by_group
from mrfp_tpu_torch.train.losses import instance_whitening_loss
from mrfp_tpu_torch.train.state import create_train_state
from mrfp_tpu_torch.train.zoo_step import covstat_pass, zoo_train_step

from torch_spatial_cases import _mesh, spatial_group

HW = 64  # the steps' and the forwards' maps


def _band(t: torch.Tensor, sp: int, s: int, dim: int = 2) -> torch.Tensor:
    lo, hi = dist.band(t.shape[dim], sp, s)
    return t.narrow(dim, lo, hi - lo).contiguous()


@contextlib.contextmanager
def _scope(group: Optional[dist.Group], maps: Sequence[torch.Tensor]):
    """The band scope of ``group`` (none for None) knowing every map of
    ``maps`` (whole NCHW maps) by its size."""
    if group is None:
        yield None
        return
    mesh = _mesh(group)
    with bands(*maps[0].shape[2:], mesh) as scope:
        for m in maps[1:]:
            scope.add(*m.shape[2:])
        yield scope


def _group(sp: int):
    """(group, index): the spatial group of ``sp`` ranks (None for sp 1,
    the whole map in this process), or "skip" for a rank outside it."""
    if sp == 1:
        return None, 0
    group = spatial_group(sp)
    return ("skip", 0) if group is None else (group, group.rank)


def pool_case(xs: list, dys: list, sp: int) -> dict:
    """SE-ResNeXt's ceil-mode stem pool on this rank's band of each map of
    ``xs``, forward and backward against the band of its ``dys``."""
    group, s = _group(sp)
    if group == "skip":
        return {"skip": True}
    outs, dxs = [], []
    for x, dy in zip(xs, dys):
        xb = (_band(x, sp, s) if group else x.clone()).requires_grad_(True)
        with _scope(group, [x]):
            out = MaxPool2d(3, 2, ceil_mode=True)(xb)
        (out * (_band(dy, sp, s) if group else dy)).sum().backward()
        outs.append(out.detach())
        dxs.append(xb.grad)
    return {"out": outs, "dx": dxs}


def sw_case(x: torch.Tensor, dy: torch.Tensor, sw_type: int, sd: dict, train: bool,
            sp: int) -> dict:
    """``SwitchWhiten2d(sw_type)`` with the state ``sd`` on this rank's band
    of ``x`` (in train mode, the whole world is the spatial group: its BW
    statistics reduce over the world), in ``x``'s dtype (fp64 through the
    layer's ``_whiten``), forward and backward against the band of ``dy``.
    The parameters' gradients are summed over the group, as the step's
    all-reduce sums them."""
    group, s = _group(sp)
    if group == "skip":
        return {"skip": True}
    sw = SwitchWhiten2d(x.shape[1], sw_type)
    sw.load_state_dict(sd)
    sw.to(x.dtype).train(train)
    xb = (_band(x, sp, s) if group else x.clone()).requires_grad_(True)
    with _scope(group, [x]):
        out = sw(xb) if x.dtype == torch.float32 else sw._whiten(xb)
    (out * (_band(dy, sp, s) if group else dy)).sum().backward()
    grads = {f"d_{k}": p.grad.clone() for k, p in sw.named_parameters()}
    if group:
        grads = {k: dist.all_reduce_sum(g, group) for k, g in grads.items()}
    return {"out": out.detach(), "dx": xb.grad, **grads,
            "running_mean": sw.running_mean, "running_cov": sw.running_cov}


def se_block_case(x: torch.Tensor, dy: torch.Tensor, sd: dict, sp: int) -> dict:
    """SE-ResNeXt's bottleneck (1x1, grouped 3x3 of stride 2, 1x1, the 1x1
    downsample of stride 2, the SE module's pooled 1x1 map and its two
    1x1s) in train mode on this rank's band of ``x`` (the whole world is the
    spatial group: the BatchNorms reduce over the world), forward and
    backward against the band of ``dy``; the parameters' gradients summed
    over the group."""
    group, s = _group(sp)
    if group == "skip":
        return {"skip": True}
    block = SEBottleneckBlock(32, 16, "seresnext", groups=8, stride=2, has_downsample=True)
    block.load_state_dict(sd)
    block.to(x.dtype).train()
    xb = (_band(x, sp, s) if group else x.clone()).requires_grad_(True)
    with _scope(group, [x]):
        out = block(xb)
    (out * (_band(dy, sp, s) if group else dy)).sum().backward()
    grads = {k: p.grad.clone() for k, p in block.named_parameters()}
    if group:
        grads = {k: dist.all_reduce_sum(g, group) for k, g in grads.items()}
    return {"out": out.detach(), "dx": xb.grad, "dparams": grads}


def wtloss_case(maps: list, masks: list, nrc: list, sp: int) -> dict:
    """``instance_whitening_loss`` over this rank's bands of ``maps`` (whole
    NCHW maps of several sizes) and ``covariance_variance`` of each: the
    rank's loss (its share; the group's sum is the loss), the gradient of
    the group's loss at each band, and each map's variance of covariance."""
    group, s = _group(sp)
    if group == "skip":
        return {"skip": True}
    xs = [(_band(m, sp, s) if group else m.clone()).requires_grad_(True) for m in maps]
    with _scope(group, maps):
        loss = instance_whitening_loss(xs, masks, 0.0, nrc)
        loss.backward()
        var = [torch.from_numpy(covariance_variance(x.detach(), 1e-5, mask.numpy()))
               for x, mask in zip(xs, masks)]
    return {"loss": loss.detach(), "dx": [x.grad for x in xs], "var": var}


# -- the zoo step -------------------------------------------------------------

# the zoo steps' plans: JAX's test_zoo_step_loss_invariant_under_mesh's ISW
# plan, and one with SwitchWhiten in slot 4 (chip_smoke.py's ZOO_DP_WT)
PLANS = {"isw": (0, 0, 0, 2, 2, 0, 0), "sw": (0, 0, 2, 2, 5, 0, 0)}


@contextlib.contextmanager
def reduced_trunks():
    """SE-ResNeXt-101 cut to (1, 1, 2, 1), as the zoo's other tests cut it."""
    saved = deepv3_zoo.ZOO_TRUNKS["se_resnext-101"]
    deepv3_zoo.ZOO_TRUNKS["se_resnext-101"] = lambda wt, variant: port_seresnext.SENet(
        layers=(1, 1, 2, 1), kind="seresnext", groups=32)
    try:
        yield
    finally:
        deepv3_zoo.ZOO_TRUNKS["se_resnext-101"] = saved


def zoo_cfg(trunk: str, variant: str, wt, use_wtloss: bool, dp: int = 1,
            sp: int = 1) -> Config:
    """The fp32 zoo recipe at rate 1 on a (dp, sp) mesh."""
    cfg = Config()
    return cfg.replace(model=dataclasses.replace(cfg.model, trunk=trunk, variant=variant,
                                                 wt_layer=tuple(wt), use_wtloss=use_wtloss),
                       train=dataclasses.replace(cfg.train, lr=1.0, compute_dtype="float32"),
                       mesh=MeshConfig(data_parallel=dp, spatial_parallel=sp))


def zoo_model(sd: dict, trunk: str, variant: str, wt) -> DeepV3Plus:
    with reduced_trunks():
        model = DeepV3Plus(trunk=trunk, variant=variant, wt_layer=tuple(wt), use_dsn=True)
    model.load_state_dict(sd, strict=True)
    return model


def _mesh_for(dp: int, sp: int):
    return create_mesh(MeshConfig(data_parallel=dp, spatial_parallel=sp)) \
        if dist.world() > 1 else None


def zoo_step_case(sd: dict, img: torch.Tensor, lbl: torch.Tensor, masks: Optional[list],
                  nrc: Optional[list], keep: torch.Tensor, trunk: str = "resnet-18",
                  variant: str = "D32", wt=PLANS["isw"], use_wtloss: bool = True,
                  dp: int = 1, sp: int = 1) -> dict:
    """One fp32 zoo step from the state ``sd`` with the whitening masks and
    the DSN keep mask of the global batch: on the (dp, sp) mesh over the
    world with this rank's part (its samples, then its band of their rows,
    the keep mask's too; None: drawn from the step's stream), or in one
    process on the whole batch. Returns the
    losses, every gradient, the state after the step and the collectives
    by group and kind."""
    cfg = zoo_cfg(trunk, variant, wt, use_wtloss, dp, sp)
    model = zoo_model(sd, trunk, variant, wt)
    state = create_train_state(model, cfg.train)
    mesh = _mesh_for(dp, sp)
    try:
        hw = None
        if mesh is not None:
            hw = tuple(img.shape[1:3])
            img, lbl = shard_batch(mesh, img), shard_batch(mesh, lbl)
            if keep is not None:
                keep = shard_batch(mesh, keep.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        with count_collectives() as log:
            m = zoo_train_step(state, img.contiguous(), lbl.contiguous(), cfg, masks, nrc,
                               dropout=None if keep is None else keep.contiguous(), hw=hw)
        return {"losses": {k: float(v) for k, v in m.items() if k.startswith("loss")},
                "collectives": summarize_by_group(log),
                "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
                "state": {k: v.clone() for k, v in model.state_dict().items()}}
    finally:
        reset_mesh()


def zoo_fp64_grads(sd: dict, img: torch.Tensor, lbl: torch.Tensor, trunk: str, variant: str,
                   wt, **_unused) -> dict:
    """The gradients of the one-process step of a zoo model without the
    whitening loss (``zoo_step_case`` with ``use_wtloss`` False and the
    keep mask drawn from the step's stream), taken in fp64 (the model, the
    images, the losses; the resizes' plain versions interpolate in fp32),
    as fp32: the reference from which an fp32 step's distances are read
    where a 1e-7-input control understates their rounding (the ASPP image
    pool's BatchNorm over the batch's 1x1 maps amplifies last-bit
    differences of the pooled means)."""
    from mrfp_tpu_torch.core.rng import device_generator
    from mrfp_tpu_torch.train.losses import cross_entropy
    from mrfp_tpu_torch.train.step import DSN_WEIGHT, dsn_cross_entropy
    model = zoo_model(sd, trunk, variant, wt).double().train()
    out = model(img.permute(0, 3, 1, 2).double(),
                dropout=device_generator(0, 0, "dropout", torch.device("cpu")))
    labels = lbl.long()
    loss = cross_entropy(out["logits"], labels) + DSN_WEIGHT * dsn_cross_entropy(out["dsn"],
                                                                                labels, 255)
    loss.backward()
    return {k: p.grad.float() for k, p in model.named_parameters()}


def covstat_case(sd: dict, pairs: list, wt=PLANS["isw"], dp: int = 1, sp: int = 1) -> dict:
    """The statistics pass over ``pairs`` (every rank the same ones, the
    whole images) on the (dp, sp) mesh, each rank its band of every view:
    the masks and counts, rank 0's on every rank."""
    model = zoo_model(sd, "resnet-18", "D32", wt)
    layers = build_cov_layers("resnet-18", wt, clusters=5)
    pairs = [tuple(v.numpy() for v in pair) for pair in pairs]
    mesh = _mesh_for(dp, sp)
    try:
        masks, nrc = covstat_pass(model, layers, pairs,
                                  zoo_cfg("resnet-18", "D32", wt, True, dp, sp),
                                  torch.device("cpu"))
        return {"masks": masks, "nrc": nrc}
    finally:
        reset_mesh()


def trunk_eval_case(sd: dict, trunk: str, variant: str, wt, x: torch.Tensor,
                    sp: int = 1) -> dict:
    """The eval forward of the zoo model over ``trunk`` on this rank's band
    of ``x`` (the whole of ``x`` without a group) on a (1, sp) mesh."""
    model = zoo_model(sd, trunk, variant, wt).eval()
    mesh = _mesh_for(1, sp)
    try:
        with torch.no_grad():
            if mesh is None:
                return {"logits": model(x)}
            xb = _band(x, sp, mesh.spatial_index)
            return {"logits": model(xb, hw=tuple(x.shape[2:]))}
    finally:
        reset_mesh()


def keep_mask(shape, seed: int, rate: float = 0.1) -> torch.Tensor:
    """A seeded DSN keep mask (bool, ``shape``)."""
    return torch.from_numpy(np.random.default_rng(seed).random(shape) >= rate)

