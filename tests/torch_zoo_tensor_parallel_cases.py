"""The cases of tests/test_torch_zoo_tensor_parallel.py and
tests/test_torch_switchwhiten_tp.py, in the port alone (no jax): each runs
in every rank of a process group (``torch_dist_group.Group``) on a (data,
model, spatial) mesh over the world, with this rank's shards of the state
(``weights.shard_model``) and its part of the batch, or in the test
process without a group on the whole batch. The ranks return whole
tensors (a model group's shards gathered), so the worker's digests of
every rank's gradients and state must equal rank 0's; ``replicated``
holds the digests of each rank's own replicated tensors, which must be
equal across a model group."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from mrfp_tpu_torch.core.config import Config, MeshConfig
from mrfp_tpu_torch.core.mesh import (bands, channels, create_mesh, current_mesh, reset_mesh,
                                      shard_batch)
from mrfp_tpu_torch.models.deepv3_zoo import DeepV3Plus, build_cov_layers
from mrfp_tpu_torch.nn.norms import SwitchWhiten2d
from mrfp_tpu_torch.nn.layers import conv2d
from mrfp_tpu_torch.nn.wider_resnet import IdentityResidualBlock
from mrfp_tpu_torch.parallel import dist
from mrfp_tpu_torch.parallel.audit import count_collectives, summarize_by_group
from mrfp_tpu_torch.train.losses import instance_whitening_loss
from mrfp_tpu_torch.train.state import create_train_state
from mrfp_tpu_torch.train.zoo_step import covstat_pass, zoo_train_step
from mrfp_tpu_torch.weights import shard_model, whole_state_dict

from torch_dist_cases import digest
from torch_spatial_cases import reduced_resnet50
from torch_spatial_zoo_cases import reduced_trunks

HW = 64  # the steps' and the forwards' maps
# the zoo step's plan: ISW in the stem and layer1, SwitchWhiten in layer2
# (chip_smoke.py's zoo legs)
WT = (0, 0, 2, 2, 5, 0, 0)


def _mesh(dp: int, mp: int, sp: int = 1):
    return create_mesh(MeshConfig(data_parallel=dp, model_parallel=mp, spatial_parallel=sp)) \
        if dist.world() > 1 else None


def _own(t: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """This rank's samples (dim 0) and channel slice (``dim``) of ``t``."""
    if mesh is None:
        return t
    b = t.shape[0] // mesh.dp
    t = t[mesh.data_index * b:(mesh.data_index + 1) * b]
    return t.chunk(mesh.mp, dim)[mesh.model_index].contiguous()


def _whole_grads(model) -> dict:
    """Every parameter's gradient, the model group's shards gathered."""
    keys, group = getattr(model, "tp_keys", frozenset()), current_mesh().model
    return {k: dist.gather_rows(p.grad, group) if k in keys else p.grad.clone()
            for k, p in model.named_parameters()}


def _replicated(model) -> dict:
    keys = getattr(model, "tp_keys", frozenset())
    return {k: digest(v) for k, v in model.state_dict().items() if k not in keys}


# -- SwitchWhiten and the whitening loss ----------------------------------------------

class _Holder(nn.Module):
    """A module whose only child is the layer, as ``shard_model`` walks
    a model."""

    def __init__(self, layer: nn.Module):
        super().__init__()
        self.sw = layer


def _part(t: torch.Tensor, mesh) -> torch.Tensor:
    """``_own`` of ``t``, then this rank's band of its rows (dim 2)."""
    t = _own(t, mesh)
    if mesh is None or mesh.sp == 1:
        return t
    lo, hi = dist.band(t.shape[2], mesh.sp, mesh.spatial_index)
    return t[:, :, lo:hi].contiguous()


def sw_case(x: torch.Tensor, dy: torch.Tensor, sw_type: int, sd: dict, train: bool,
            dp: int = 1, mp: int = 1, sp: int = 1) -> dict:
    """``SwitchWhiten2d(sw_type)`` with the whole state ``sd``, cut over the
    model axis of a (dp, mp, sp) mesh, on this rank's samples, channel
    slice and band of rows of ``x`` (fp64), in a channel scope (and a band
    scope); the backward of the sum of ``out * dy`` over this rank's part.
    The parameters' gradients are summed over the replica group (as the
    step's all-reduce sums them) and gathered whole; the running buffers
    whole after the step."""
    holder = _Holder(SwitchWhiten2d(x.shape[1], sw_type))
    holder.load_state_dict({f"sw.{k}": v for k, v in sd.items()})
    holder.to(x.dtype).train(train)
    mesh = _mesh(dp, mp, sp)
    try:
        holder = shard_model(holder, current_mesh())
        xb = _part(x, mesh).requires_grad_(True)
        with bands(*x.shape[2:]), channels():
            out = holder.sw(xb)
        (out * _part(dy, mesh)).sum().backward()
        dist.all_reduce_grads(holder.parameters(), current_mesh().replica)
        grads = {f"d_{k.removeprefix('sw.')}": v for k, v in _whole_grads(holder).items()}
        state = whole_state_dict(holder, current_mesh())
        return {"out": out.detach(), "dx": xb.grad, **grads,
                "running_mean": state["sw.running_mean"], "running_cov": state["sw.running_cov"],
                "shapes": {k: tuple(v.shape) for k, v in holder.state_dict().items()}}
    finally:
        reset_mesh()


def wtloss_case(maps: list, masks: list, nrc: list, mp: int = 1) -> dict:
    """``instance_whitening_loss`` over the whitening maps of a model
    group of ``mp`` ranks, each handed whole (``Channels.whole_of`` of this
    rank's channel slice, as ``nn.norms.collect_map`` hands them over):
    the loss and the gradient at this rank's slice of each map."""
    mesh = _mesh(1, mp)
    try:
        xs = [_own(m, mesh).requires_grad_(True) for m in maps]
        with channels() as chans:
            whole = [x if chans is None else chans.whole_of(x, m.shape[1])
                     for x, m in zip(xs, maps)]
        loss = instance_whitening_loss(whole, masks, 0.0, nrc)
        loss.backward()
        return {"loss": loss.detach(), "dx": [x.grad for x in xs]}
    finally:
        reset_mesh()


# -- the zoo step -------------------------------------------------------------

def zoo_cfg(trunk: str, variant: str, wt, use_wtloss: bool, dp: int = 1, mp: int = 1,
            sp: int = 1) -> Config:
    """The fp32 zoo recipe at rate 1 with the DSN head on a (dp, mp, sp)
    mesh."""
    cfg = Config()
    return cfg.replace(model=dataclasses.replace(cfg.model, trunk=trunk, variant=variant,
                                                 wt_layer=tuple(wt), use_wtloss=use_wtloss,
                                                 use_dsn_aux=True),
                       train=dataclasses.replace(cfg.train, lr=1.0, compute_dtype="float32"),
                       mesh=MeshConfig(data_parallel=dp, model_parallel=mp,
                                       spatial_parallel=sp))


def zoo_model(sd: dict, trunk: str, variant: str, wt, use_dsn: bool = True) -> DeepV3Plus:
    """The zoo model over ``trunk`` (resnet-50 at depth (1, 1, 1, 1),
    SE-ResNeXt-101 at (1, 1, 2, 1)) with the whole state ``sd``."""
    with reduced_resnet50(), reduced_trunks():
        model = DeepV3Plus(trunk=trunk, variant=variant, wt_layer=tuple(wt), use_dsn=use_dsn)
    model.load_state_dict(sd, strict=True)
    return model


def _shapes(state) -> dict:
    """This rank's shard shapes: every parameter, its momentum and every
    buffer."""
    model = state.model
    out = {f"param:{k}": tuple(p.shape) for k, p in model.named_parameters()}
    out.update({f"momentum:{k}": tuple(state.optimizer.state[p]["momentum_buffer"].shape)
                for k, p in model.named_parameters() if p in state.optimizer.state})
    out.update({f"buffer:{k}": tuple(b.shape) for k, b in model.named_buffers()})
    return out


def zoo_step_case(sd: dict, img: torch.Tensor, lbl: torch.Tensor, masks: Optional[list],
                  nrc: Optional[list], keep: Optional[torch.Tensor], trunk: str = "resnet-50",
                  variant: str = "D16", wt=WT, use_wtloss: bool = True, dp: int = 1,
                  mp: int = 1, sp: int = 1, dtype: str = "float32") -> dict:
    """One zoo step (rate 1) from the whole state ``sd`` with the whitening
    masks and the DSN keep mask of the global batch (NCHW, every channel;
    None: drawn from the step's stream): on the (dp, mp, sp) mesh over the
    world, this rank's shards and its part of the batch (its samples, then
    its band of their rows), or without a group on the whole batch. Returns
    the losses, the whole gradients and state after the step, the digests
    of this rank's replicated tensors, its shard shapes and its
    collectives by group and kind."""
    cfg = zoo_cfg(trunk, variant, wt, use_wtloss, dp, mp, sp)
    model = zoo_model(sd, trunk, variant, wt).to(getattr(torch, dtype))
    mesh = _mesh(dp, mp, sp)
    try:
        model = shard_model(model, current_mesh())
        state = create_train_state(model, cfg.train)
        hw = None
        if mesh is not None:
            hw = tuple(img.shape[1:3]) if sp > 1 else None
            img, lbl = shard_batch(mesh, img), shard_batch(mesh, lbl)
            if keep is not None:
                keep = shard_batch(mesh, keep.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        with count_collectives() as log:
            m = zoo_train_step(state, img.to(getattr(torch, dtype)).contiguous(),
                               lbl.contiguous(), cfg, masks, nrc,
                               dropout=None if keep is None else keep.contiguous(), hw=hw)
        return {"losses": {k: float(v) for k, v in m.items() if k.startswith("loss")},
                "collectives": summarize_by_group(log), "grads": _whole_grads(model),
                "state": {k: v.clone() for k, v in whole_state_dict(model,
                                                                    current_mesh()).items()},
                "replicated": _replicated(model), "shapes": _shapes(state)}
    finally:
        reset_mesh()


def zoo_grad_case(sd: dict, trunk: str, variant: str, wt, x: torch.Tensor, dy: torch.Tensor,
                  dp: int = 1, mp: int = 1) -> dict:
    """The zoo model over ``trunk`` without the DSN head, train mode, fp64:
    one forward of ``x`` and the backward of ``(logits * dy).sum()`` on a
    (dp, mp, 1) mesh (or whole without a group); the logits, the input's
    gradient and every parameter's whole gradient (summed over the replica
    group)."""
    model = zoo_model(sd, trunk, variant, wt, use_dsn=False)
    mesh = _mesh(dp, mp)
    try:
        model = shard_model(model, current_mesh()).double().train()
        if mesh is not None:
            b = x.shape[0] // mesh.dp
            x, dy = (t[mesh.data_index * b:(mesh.data_index + 1) * b] for t in (x, dy))
        xi = x.clone().requires_grad_(True)
        logits = model(xi)["logits"]
        (logits * dy).sum().backward()
        dist.all_reduce_grads(model.parameters(), current_mesh().replica)
        return {"logits": logits.detach(), "dx": xi.grad, "grads": _whole_grads(model),
                "replicated": _replicated(model)}
    finally:
        reset_mesh()


def wider_blocks() -> nn.Sequential:
    """WiderResNet's stem conv and block kinds (``nn/wider_resnet.py``),
    channel counts cut down: a strided projection shortcut, a dilated pair,
    a bottleneck."""
    return nn.Sequential(conv2d(3, 16, 3, 1, 1), IdentityResidualBlock(16, (32, 32), 2),
                         IdentityResidualBlock(32, (32, 32), 1, 2),
                         IdentityResidualBlock(32, (16, 32, 64), 1, 2))


def wider_case(sd: dict, x: torch.Tensor, dy: torch.Tensor, mp: int = 1) -> dict:
    """``wider_blocks`` in train mode, fp64, cut over a (1, mp, 1) mesh: one
    forward of ``x`` in a channel scope and the backward of ``out * dy``
    summed over this rank's slice of the output; the output gathered
    whole, the input's gradient and every parameter's whole gradient."""
    net = wider_blocks()
    net.load_state_dict(sd, strict=True)
    mesh = _mesh(1, mp)
    try:
        net = shard_model(net, current_mesh()).double().train()
        xi = x.clone().requires_grad_(True)
        with channels() as chans:
            out = net(xi)
            whole = out if chans is None else chans.whole_of(out, dy.shape[1])
        (out * _own(dy, mesh)).sum().backward()
        return {"out": whole.detach(), "dx": xi.grad, "grads": _whole_grads(net)}
    finally:
        reset_mesh()


def covstat_case(sd: dict, pairs: list, mp: int = 1) -> dict:
    """The statistics pass of ``cli.train_zoo`` over ``pairs`` (the same on
    every rank) for the model cut over a (1, mp, 1) mesh: on the whole
    model it gathers (``cli.train_zoo.whole_model``); the masks and
    counts."""
    from mrfp_tpu_torch.cli.train_zoo import whole_model
    cfg = zoo_cfg("resnet-50", "D16", WT, True, 1, mp)
    model = zoo_model(sd, "resnet-50", "D16", WT)
    layers = build_cov_layers("resnet-50", WT, clusters=5)
    pairs = [tuple(v.numpy() for v in pair) for pair in pairs]
    _mesh(1, mp)
    try:
        model = shard_model(model, current_mesh())
        with reduced_resnet50():
            whole = whole_model(cfg, model, torch.device("cpu"))
        masks, nrc = covstat_pass(whole, layers, pairs, cfg, torch.device("cpu"))
        return {"masks": masks, "nrc": nrc}
    finally:
        reset_mesh()


def eval_case(sd: dict, trunk: str, variant: str, wt, x: torch.Tensor, mp: int = 1) -> dict:
    """The eval forward of the zoo model cut over a (world / mp, mp, 1)
    mesh (or whole without a group)."""
    model = zoo_model(sd, trunk, variant, wt).eval()
    _mesh(dist.world() // mp, mp)
    try:
        model = shard_model(model, current_mesh())
        with torch.no_grad():
            return {"logits": model(x)}
    finally:
        reset_mesh()

