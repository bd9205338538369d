"""The cases of tests/test_torch_spatial_extras.py, in the port alone (no
jax): each runs in every rank of a process group (``torch_dist_group.Group``)
on that rank's band of rows, or in the test process on the whole map, with
the same code. A case of a spatial group of ``sp`` ranks runs on ranks
``0..sp-1`` of the world; the others return ``{"skip": True}``."""

from __future__ import annotations

import dataclasses

import torch

from mrfp_tpu_torch.core.config import MeshConfig, mrfp_plus_config
from mrfp_tpu_torch.core.mesh import create_mesh, reset_mesh
from mrfp_tpu_torch.models import MRFP
from mrfp_tpu_torch.models.mrfp import PerturbArgs
from mrfp_tpu_torch.nn.layers import Conv2d, conv1x1_with_stats, init_random_
from mrfp_tpu_torch.parallel import dist
from mrfp_tpu_torch.parallel.audit import count_collectives, summarize_by_group
from mrfp_tpu_torch.perturb.oc_branch import oc_init
from mrfp_tpu_torch.train.losses import (batch_class_weights, relaxed_cross_entropy,
                                         relaxed_multihot)
from mrfp_tpu_torch.train.state import create_train_state
from mrfp_tpu_torch.train.step import band_batch, train_step

from torch_spatial_cases import HW, reduced_resnet50
from torch_spatial_zoo_cases import _band, _group, _scope

NUM_CLASSES = 19


def relaxed_case(labels: torch.Tensor, border: int, reduce_now: bool, strict, sp: int) -> dict:
    """The border-relaxed target of this rank's band of the (N, H, W)
    ``labels`` (ignore 255)."""
    group, s = _group(sp)
    if group == "skip":
        return {"skip": True}
    lb = _band(labels, sp, s, dim=1) if group else labels
    with _scope(group, [labels[:, None]]):
        allowed, weight = relaxed_multihot(lb, NUM_CLASSES, 255, border, reduce_now, strict)
    return {"allowed": allowed, "weight": weight}


def relaxed_loss_case(logits: torch.Tensor, labels: torch.Tensor, border: int,
                      reduce_now: bool, sp: int) -> dict:
    """The relaxed CE of this rank's band of ``logits`` (its numerator the
    band's, the weights' sum the world's: the world is the group) and the
    class weights of its band of ``labels`` (a world histogram)."""
    group, s = _group(sp)
    if group == "skip":
        return {"skip": True}
    lg = (_band(logits, sp, s) if group else logits.clone()).requires_grad_(True)
    lb = _band(labels, sp, s, dim=1) if group else labels
    with _scope(group, [logits]):
        loss = relaxed_cross_entropy(lg, lb, NUM_CLASSES, 255, border, reduce_now)
        loss.backward()
        weights = batch_class_weights(lb, NUM_CLASSES, 255)
    return {"loss": loss.detach(), "dlogits": lg.grad, "class_weights": weights}


def conv1x1_case(x: torch.Tensor, weight: torch.Tensor, stride: int, dy: torch.Tensor,
                 a: torch.Tensor, b: torch.Tensor, sp: int) -> dict:
    """``conv1x1_with_stats`` (the plain ``dot_with_stats``) of a 1x1 conv of
    ``stride`` on this rank's band of ``x``: ``y`` (the output band), the
    sums ``s1``, ``s2`` and the count ``n`` summed over the group, and the
    gradient of ``(y dy).sum() + (s1 a).sum() + (s2 b).sum()`` (the
    group's sum of the ranks' terms) at the input band."""
    group, s = _group(sp)
    if group == "skip":
        return {"skip": True}
    conv = Conv2d(x.shape[1], weight.shape[0], 1, stride=stride, bias=False).to(x.dtype)
    conv.weight.data.copy_(weight[:, :, None, None])
    xb = (_band(x, sp, s) if group else x.clone()).requires_grad_(True)
    with _scope(group, [x]):
        y, s1, s2, n = conv1x1_with_stats(conv, xb, "plain")
    dyb = _band(dy, sp, s) if group else dy
    ((y * dyb).sum() + (s1 * a).sum() + (s2 * b).sum()).backward()
    sums = torch.stack([s1.detach(), s2.detach(), torch.full_like(s1, n)])
    if group:
        sums = dist.all_reduce_sum(sums.clone(), group)
    return {"y": y.detach(), "s1": sums[0], "s2": sums[1], "n": sums[2], "dx": xb.grad,
            "dw": conv.weight.grad if not group else dist.all_reduce_sum(
                conv.weight.grad.clone(), group)}


# the extras' steps: cfg.data / cfg.train changes of the MRFP+ recipe
EXTRAS = {
    "border": dict(data=dict(jointwtborder=True, border_window=2)),
    # -1 is never; from step 0 the window halves and the boundary weighs 2
    "border_reduced": dict(data=dict(jointwtborder=True, border_window=3,
                                     reduce_border_iter=-2, strict_border_class=(0, 5))),
    "hpf": dict(data=dict(freq_transform="hpf", batch_weighting=True)),
    "lpf": dict(data=dict(freq_transform="lpf")),
    "phot": dict(data=dict(freq_transform="phot")),
    "fused": dict(train=dict(fuse_bn_stats=True)),
}


def extras_cfg(extra: str, dp: int = 1, sp: int = 1):
    """The fp32 MRFP+ recipe at rate 1 with one of ``EXTRAS`` on a (dp, sp)
    mesh."""
    cfg = mrfp_plus_config()
    change = EXTRAS[extra]
    return cfg.replace(
        train=dataclasses.replace(cfg.train, compute_dtype="float32", lr=1.0,
                                  **change.get("train", {})),
        data=dataclasses.replace(cfg.data, **change.get("data", {})),
        mesh=MeshConfig(data_parallel=dp, spatial_parallel=sp))


def fixture_state(seed: int = 5) -> dict:
    """The damped fixture of the extras' steps: resnet-50 at depth
    (1, 1, 1, 1), D16, the MRFP+ heads and OC buffers, seeded random
    weights, every ``bn3`` scale x0.1."""
    with reduced_resnet50():
        model = MRFP(oc_branch=True, hrfp_plus=True)
    init_random_(model, torch.Generator().manual_seed(seed))
    model.load_state_dict(oc_init(torch.Generator().manual_seed(seed + 1), 0.5), strict=False)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bn3.weight"):
                p.mul_(0.1)
    return {k: v.clone() for k, v in model.state_dict().items()}


def extras_step_case(sd: dict, img: torch.Tensor, lbl: torch.Tensor, extra: str,
                     dp: int = 1, sp: int = 1) -> dict:
    """One fp32 MRFP+ step with the extra ``extra``, every gate off (the
    gated step on bands is tests/test_torch_spatial.py's; here fp32's ReLU
    flips under NP+ and OC together move the step further than a 1e-7
    change of the input does, ROADMAP C3): on the (dp, sp) mesh over the world with
    this rank's band of its data rank's samples (``band_batch``: the FFT
    transforms on the whole images first), or in one process on the whole
    batch. Returns the loss, every gradient, the state after the step and
    the collectives by group and kind."""
    cfg = extras_cfg(extra, dp, sp)
    with reduced_resnet50():
        model = MRFP(oc_branch=True, hrfp_plus=True)
    model.load_state_dict(sd, strict=True)
    state = create_train_state(model.train(), cfg.train)
    mesh = create_mesh(cfg.mesh) if dist.world() > 1 else None
    perturb = PerturbArgs(False, False, False, None, None)
    try:
        with count_collectives() as log:
            if mesh is None:
                m = train_step(state, img, lbl, cfg, perturb=perturb)
            else:
                b, d = img.shape[0] // mesh.dp, mesh.data_index
                x, y, hw = band_batch(mesh, img[d * b:(d + 1) * b], lbl[d * b:(d + 1) * b],
                                      cfg)
                m = train_step(state, x, y, cfg, perturb=perturb, hw=hw, transformed=True)
        return {"loss": float(m["loss"]), "collectives": summarize_by_group(log),
                "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
                "state": {k: v.clone() for k, v in model.state_dict().items()}}
    finally:
        reset_mesh()



def extras_fp64_grads(sd: dict, img: torch.Tensor, lbl: torch.Tensor, extra: str,
                      **_unused) -> dict:
    """The gradients of ``extras_step_case``'s one-process step taken in
    fp64 (the model, the images and the losses; the FFT transforms' fp32
    output and the resizes' plain versions, which interpolate in fp32,
    apart), as fp32: the reference of ``torch_step_checks.
    as_close_as_the_control_or_fp64``."""
    cfg = extras_cfg(extra)
    with reduced_resnet50():
        model = MRFP(oc_branch=True, hrfp_plus=True)
    model.load_state_dict(sd, strict=True)
    model = model.double()
    state = create_train_state(model.train(), cfg.train)
    train_step(state, img.double(), lbl, cfg, perturb=PerturbArgs(False, False, False, None,
                                                                  None))
    return {k: p.grad.float() for k, p in model.named_parameters()}
