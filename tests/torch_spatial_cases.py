"""The cases of tests/test_torch_spatial.py, in the port alone (no jax):
each runs in every rank of a process group (``torch_dist_group.Group``) on
that rank's band of rows, and the test holds the bands against the whole
map computed in one process. A case of a spatial group of ``sp`` ranks
runs on ranks ``0..sp-1`` of the world; the others return None."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from mrfp_tpu_torch.core.config import MeshConfig, mrfp_plus_config
from mrfp_tpu_torch.core.mesh import Mesh, bands, create_mesh, reset_mesh, shard_batch
from mrfp_tpu_torch.data import SyntheticDataset
from mrfp_tpu_torch.models import MRFP
from mrfp_tpu_torch.models.mrfp import PerturbArgs
from mrfp_tpu_torch.nn import resnet as port_resnet
from mrfp_tpu_torch.nn.layers import Conv2d, MaxPool2d
from mrfp_tpu_torch.nn.norms import InstanceNorm2d
from mrfp_tpu_torch.parallel import dist
from mrfp_tpu_torch.parallel.audit import count_collectives, summarize_by_group
from mrfp_tpu_torch.train.evaluator import SegEvaluator
from mrfp_tpu_torch.train.state import create_train_state
from mrfp_tpu_torch.train.step import train_step

HW = 64          # the step's and the eval's maps
LAYERS = (1, 1, 1, 1)  # resnet-50 at reduced depth, as the family parity tests run it

_PGS = {}


def spatial_group(sp: int) -> Optional[dist.Group]:
    """A spatial group of world ranks ``0..sp-1``; every rank creates its
    process group (once), the ranks outside get None."""
    n, me = dist.world(), dist.rank()
    if sp not in _PGS:
        _PGS[sp] = None if sp == n else torch.distributed.new_group(list(range(sp)))
    return dist.Group("spatial", _PGS[sp], sp, me) if me < sp else None


def _mesh(group: dist.Group) -> Mesh:
    return Mesh(1, group.size, dist.Group("data", None, 1, 0), group)


@contextlib.contextmanager
def reduced_resnet50(layers=LAYERS):
    """``resnet-50`` built at depth ``layers`` inside the block."""
    saved = port_resnet._TRUNKS["resnet-50"]
    port_resnet._TRUNKS["resnet-50"] = dict(saved, layers=tuple(layers))
    try:
        yield
    finally:
        port_resnet._TRUNKS["resnet-50"] = saved


def rows_case(x: torch.Tensor, dys: list, sp: int, lo: list, hi: list, fill: float) -> dict:
    """``rows_from_group`` of this rank's band of the map ``x``, forward
    and backward (``(out * dys[s]).sum()``)."""
    group = spatial_group(sp)
    if group is None:
        return {"skip": True}
    h = x.shape[2]
    b0, b1 = dist.band(h, sp, group.rank)
    xb = x[:, :, b0:b1].clone().requires_grad_(True)
    out = dist.rows_from_group(xb, h, lo, hi, group, fill)
    (out * dys[group.rank]).sum().backward()
    return {"out": out.detach(), "dx": xb.grad}


def op_case(op: str, sp: int, x: torch.Tensor, dy: torch.Tensor, kw: dict,
            sd: Optional[dict] = None) -> dict:
    """One band op on this rank's band of ``x`` in a spatial scope, forward
    and backward against the band of ``dy`` (the whole op's cotangent):
    ``op`` "conv" (``Conv2d(**kw)``, state ``sd``), "pool" (the stem's
    max pool) or "in" (``InstanceNorm2d(**kw)``, state ``sd``). The
    parameters' gradients are summed over the group, as the step's
    all-reduce sums them."""
    group = spatial_group(sp)
    if group is None:
        return {"skip": True}
    module = {"conv": lambda: Conv2d(**kw), "pool": lambda: MaxPool2d(3, 2, 1),
              "in": lambda: InstanceNorm2d(**kw)}[op]().to(x.dtype)
    if sd is not None:
        module.load_state_dict(sd)
    h, w = x.shape[2:]
    b0, b1 = dist.band(h, sp, group.rank)
    xb = x[:, :, b0:b1].clone().requires_grad_(True)
    with bands(h, w, _mesh(group)):
        out = module(xb)
    o0, o1 = dist.band(dy.shape[2], sp, group.rank)
    (out * dy[:, :, o0:o1]).sum().backward()
    grads = {k: dist.all_reduce_sum(p.grad.clone(), group) for k, p in module.named_parameters()}
    return {"out": out.detach(), "dx": xb.grad, "dparams": grads}


def step_cfg(dp: int, sp: int):
    """The fp32 MRFP+ recipe at rate 1 on a (dp, sp) mesh."""
    cfg = mrfp_plus_config()
    return cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype="float32", lr=1.0),
                       mesh=MeshConfig(data_parallel=dp, spatial_parallel=sp))


def step_case(sd: dict, img: torch.Tensor, lbl: torch.Tensor, draws: dict, dp: int = 1,
              sp: int = 1) -> dict:
    """One fp32 MRFP+ step, all gates on, the NP+ draws (of the global
    batch) injected, from the state ``sd``: on the (dp, sp) mesh over the
    world with this rank's part of the batch (its samples, then its band
    of their rows), or without a group on the whole batch. Returns the
    loss, every gradient, the state after the step and the collectives
    by group."""
    cfg = step_cfg(dp, sp)
    with reduced_resnet50():
        model = MRFP(oc_branch=True, hrfp_plus=True)
    model.load_state_dict(sd, strict=True)
    state = create_train_state(model.train(), cfg.train)
    mesh = create_mesh(cfg.mesh) if dist.world() > 1 else None
    try:
        n = img.shape[0]
        if mesh is not None:
            b, d = n // mesh.dp, mesh.data_index
            np0, np1 = (tuple(t[d * b:(d + 1) * b] for t in draws[k]) for k in ("np0", "np1"))
            img, lbl = shard_batch(mesh, img), shard_batch(mesh, lbl)
        else:
            np0, np1 = draws["np0"], draws["np1"]
        perturb = PerturbArgs(True, True, True, np0, np1)
        with count_collectives() as log:
            loss = train_step(state, img.contiguous(), lbl.contiguous(), cfg, perturb=perturb,
                              hw=(HW, HW))
        return {"loss": float(loss["loss"]),
                "collectives": summarize_by_group(log),
                "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
                "state": {k: v.clone() for k, v in model.state_dict().items()}}
    finally:
        reset_mesh()


def eval_case(sd: dict, x: torch.Tensor, sp: int, length: int = 3,
              seed: int = 11) -> dict:
    """The eval forward on this rank's band of ``x`` (the whole of ``x``
    without a group), and ``SegEvaluator``'s histograms over a synthetic
    dataset at ``eval_batch`` 1 and 2, on a (1, sp) mesh."""
    with reduced_resnet50():
        model = MRFP()
    model.load_state_dict(sd, strict=True)
    model.eval()
    mesh = create_mesh(MeshConfig(data_parallel=1, spatial_parallel=sp)) \
        if dist.world() > 1 else None
    try:
        h, w = x.shape[2:]
        with torch.no_grad():
            if mesh is None:
                logits = model(x)
            else:
                lo, hi = dist.band(h, sp, mesh.spatial_index)
                logits = model(x[:, :, lo:hi].contiguous(), hw=(h, w))
        ds = SyntheticDataset(length=length, hw=(HW, HW), seed=seed)
        hists = {}
        for eb in (1, 2):
            res = SegEvaluator(model, device="cpu", eval_batch=eb, mesh=mesh).run(
                ds, log=lambda *a, **k: None)
            hists[eb] = torch.from_numpy(np.asarray(res["hist"]))
        return {"logits": logits, "hists": hists}
    finally:
        reset_mesh()
