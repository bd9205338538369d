"""The cases of tests/test_torch_tensor_parallel.py, in the port alone (no
jax): each runs in every rank of a process group
(``torch_dist_group.Group``) on a (data, model, spatial) mesh over the
world, and the test holds what the ranks computed against one process.
The ranks return whole tensors (a model group's shards gathered), so the
worker's digests of every rank's gradients and state must equal rank 0's;
``replicated`` holds the digests of each rank's own replicated tensors,
which must be equal across a model group."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from mrfp_tpu_torch.core.config import MeshConfig, mrfp_plus_config
from mrfp_tpu_torch.core.mesh import create_mesh, current_mesh, reset_mesh, shard_batch
from mrfp_tpu_torch.models import MRFP
from mrfp_tpu_torch.models.mrfp import PerturbArgs
from mrfp_tpu_torch.nn import resnet as port_resnet
from mrfp_tpu_torch.parallel import dist
from mrfp_tpu_torch.parallel.audit import count_collectives, summarize_by_group
from mrfp_tpu_torch.train.state import create_train_state
from mrfp_tpu_torch.train.step import train_step
from mrfp_tpu_torch.weights import shard_model, shard_state_dict, whole_state_dict

from torch_dist_cases import digest
from torch_spatial_cases import HW, reduced_resnet50


def _mesh(dp: int, mp: int, sp: int):
    return create_mesh(MeshConfig(data_parallel=dp, model_parallel=mp, spatial_parallel=sp)) \
        if dist.world() > 1 else None


@contextlib.contextmanager
def reduced_resnext50():
    """``resnext-50`` built at depth (1, 1, 1, 1) inside the block."""
    saved = port_resnet._TRUNKS["resnext-50"]
    port_resnet._TRUNKS["resnext-50"] = dict(saved, layers=(1, 1, 1, 1))
    try:
        yield
    finally:
        port_resnet._TRUNKS["resnext-50"] = saved


def _whole_grads(model) -> dict:
    """Every parameter's gradient, the model group's shards gathered."""
    keys, group = getattr(model, "tp_keys", frozenset()), current_mesh().model
    return {k: dist.gather_rows(p.grad, group) if k in keys else p.grad.clone()
            for k, p in model.named_parameters()}


def _shapes(state) -> dict:
    """This rank's shard shapes: every parameter, its momentum and every
    buffer."""
    model = state.model
    out = {f"param:{k}": tuple(p.shape) for k, p in model.named_parameters()}
    out.update({f"momentum:{k}": tuple(state.optimizer.state[p]["momentum_buffer"].shape)
                for k, p in model.named_parameters() if p in state.optimizer.state})
    out.update({f"buffer:{k}": tuple(b.shape) for k, b in model.named_buffers()})
    return out


def _replicated(model) -> dict:
    keys = getattr(model, "tp_keys", frozenset())
    return {k: digest(v) for k, v in model.state_dict().items() if k not in keys}


def step_cfg(dp: int, mp: int, sp: int, fused: bool = False, dsn: bool = False):
    """The fp32 MRFP+ recipe at rate 1 on a (dp, mp, sp) mesh."""
    cfg = mrfp_plus_config()
    return cfg.replace(
        train=dataclasses.replace(cfg.train, compute_dtype="float32", lr=1.0,
                                  fuse_bn_stats=fused),
        model=dataclasses.replace(cfg.model, use_dsn_aux=dsn),
        mesh=MeshConfig(data_parallel=dp, model_parallel=mp, spatial_parallel=sp))


def tp_step_case(sd: dict, img: torch.Tensor, lbl: torch.Tensor, draws: dict, dp: int = 1,
                 mp: int = 1, sp: int = 1, fused: bool = False, dsn_seed: Optional[int] = None,
                 dtype: str = "float32") -> dict:
    """One MRFP+ step (rate 1, every gate on, the NP+ draws of the global
    batch and of every channel injected, with ``dsn_seed`` the DSN head and
    its dropout drawn from that seed) from the whole state ``sd``: on the
    (dp, mp, sp) mesh over the world, this rank's shards of the state and
    its part of the batch, or without a group on the whole batch. Returns
    the loss, the whole gradients and state after the step (the model
    group's shards gathered), the digests of this rank's replicated
    tensors, its shard shapes and its collectives by group."""
    cfg = step_cfg(dp, mp, sp, fused, dsn_seed is not None)
    with reduced_resnet50():
        model = MRFP(oc_branch=True, hrfp_plus=True, use_dsn=dsn_seed is not None)
    model.load_state_dict(sd, strict=True)
    model = model.to(getattr(torch, dtype))
    mesh = _mesh(dp, mp, sp)
    try:
        model = shard_model(model, current_mesh())
        state = create_train_state(model.train(), cfg.train)
        n = img.shape[0]
        if mesh is not None:
            b, d = n // mesh.dp, mesh.data_index
            np0, np1 = (tuple(t[d * b:(d + 1) * b] for t in draws[k]) for k in ("np0", "np1"))
            img, lbl = shard_batch(mesh, img), shard_batch(mesh, lbl)
        else:
            np0, np1 = draws["np0"], draws["np1"]
        perturb = PerturbArgs(True, True, True, np0, np1)
        dropout = None if dsn_seed is None else torch.Generator().manual_seed(dsn_seed)
        with count_collectives() as log:
            loss = train_step(state, img.to(getattr(torch, dtype)).contiguous(),
                              lbl.contiguous(), cfg, perturb=perturb, dropout=dropout,
                              hw=(HW, HW) if sp > 1 else None)
        return {"loss": float(loss["loss"]), "collectives": summarize_by_group(log),
                "grads": _whole_grads(model),
                "state": {k: v.clone() for k, v in whole_state_dict(model, current_mesh()).items()},
                "replicated": _replicated(model), "shapes": _shapes(state)}
    finally:
        reset_mesh()


def round_trip_case(sd: dict, mp: int) -> dict:
    """A whole state cut to this rank's shards by ``shard_model`` and by
    ``shard_state_dict`` (the same), and gathered back by
    ``whole_state_dict`` on a (world / mp, mp, 1) mesh: whether every
    tensor comes back bit for bit."""
    with reduced_resnet50():
        model = MRFP(oc_branch=True, hrfp_plus=True)
    model.load_state_dict(sd, strict=True)
    mesh = _mesh(dist.world() // mp, mp, 1)
    try:
        model = shard_model(model, mesh)
        cut = shard_state_dict(sd, mesh)
        same_cut = all(torch.equal(v, cut[k]) for k, v in model.state_dict().items())
        back = whole_state_dict(model, mesh)
        return {"same_cut": same_cut, "whole": all(torch.equal(back[k], v) for k, v in sd.items()),
                "keys": sorted(back) == sorted(sd)}
    finally:
        reset_mesh()


def conjugates_case(x: torch.Tensor, parts: tuple, dys: list, mp: int) -> dict:
    """The three channel conjugates on the model groups of a (world / mp,
    mp, 1) mesh, fp64: ``gather_channels`` of this rank's slice of each
    block of ``x`` (``parts``: the blocks' whole channel counts),
    ``copy_to_group`` of ``x`` and ``slice_channels`` of ``x``, each
    backward against this rank's cotangent ``dys[m]``."""
    mesh = _mesh(dist.world() // mp, mp, 1)
    try:
        m, group = mesh.model_index, mesh.model
        blocks, at = [], 0
        for size in parts:
            c = size // mp
            blocks.append(x[:, at + m * c:at + (m + 1) * c])
            at += size
        local = torch.cat(blocks, dim=1).clone().requires_grad_(True)
        gathered = dist.gather_channels(local, group, [size // mp for size in parts])
        (gathered * dys[m]).sum().backward()
        xc = x.clone().requires_grad_(True)
        copied = dist.copy_to_group(xc, group)
        (copied * dys[m]).sum().backward()
        xs = x.clone().requires_grad_(True)
        sliced = dist.slice_channels(xs, group)
        c = x.shape[1] // mp
        (sliced * dys[m][:, m * c:(m + 1) * c]).sum().backward()
        return {"gathered": gathered.detach(), "d_gathered": local.grad,
                "copied": copied.detach(), "d_copied": xc.grad,
                "sliced": sliced.detach(), "d_sliced": xs.grad}
    finally:
        reset_mesh()


def tp_eval_case(sd: dict, x: torch.Tensor, mp: int) -> dict:
    """The eval forward of the whole state ``sd`` cut over a (world / mp, mp,
    1) mesh (or whole without a group)."""
    with reduced_resnet50():
        model = MRFP()
    model.load_state_dict(sd, strict=True)
    model.eval()
    mesh = _mesh(dist.world() // mp, mp, 1)
    try:
        model = shard_model(model, current_mesh())
        with torch.no_grad():
            return {"logits": model(x)}
    finally:
        reset_mesh()


def grouped_case(sd: dict, x: torch.Tensor, dy: torch.Tensor, mp: int) -> dict:
    """``resnext-50`` at depth (1, 1, 1, 1), train mode without
    perturbation: one forward of ``x`` and the backward of ``(logits *
    dy).sum()`` on a (world / mp, mp, 1) mesh (or whole without a group);
    the logits, the input's gradient and every parameter's whole
    gradient."""
    with reduced_resnext50():
        model = MRFP(trunk="resnext-50")
    model.load_state_dict(sd, strict=True)
    mesh = _mesh(dist.world() // mp, mp, 1)
    try:
        model = shard_model(model, current_mesh()).double().train()
        if mesh is not None:
            b = x.shape[0] // mesh.dp
            x, dy = (t[mesh.data_index * b:(mesh.data_index + 1) * b] for t in (x, dy))
        xi = x.clone().requires_grad_(True)
        logits = model(xi)
        (logits * dy).sum().backward()
        dist.all_reduce_grads(model.parameters(), current_mesh().replica)
        return {"logits": logits.detach(), "dx": xi.grad, "grads": _whole_grads(model)}
    finally:
        reset_mesh()


def plan_step_case(argv: list) -> dict:
    """``cli.plan``'s rank: one step of its config and batch on the mesh of
    its flags, under the count; the collectives by group."""
    from mrfp_tpu_torch.cli import plan
    from mrfp_tpu_torch.cli.train import build_state
    args = plan.parse_args(argv)
    cfg = plan.train_config(args, args.crop_size)
    mesh = create_mesh(cfg.mesh)
    try:
        state = build_state(cfg, torch.device("cpu"))
        img, lbl = plan.step_batch(mesh.dp, mesh.data_index, args.batch_size, args.crop_size,
                                   "cpu")
        with count_collectives() as log:
            float(train_step(state, img, lbl, cfg)["loss"])
        return {"by_group": summarize_by_group(log)}
    finally:
        reset_mesh()
