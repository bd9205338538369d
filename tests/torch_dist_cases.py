"""The cases of tests/test_torch_dist.py, in the port alone (no jax): each
runs in one process on a whole batch, or in each rank of a process group on
that rank's rows of it, with the same code. ``rows`` is this process's
slice of a global batch of ``n`` (the whole batch without a group)."""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from mrfp_tpu_torch.core.config import mrfp_plus_config
from mrfp_tpu_torch.data import SyntheticDataset
from mrfp_tpu_torch.models import MRFP
from mrfp_tpu_torch.models.mrfp import PerturbArgs
from mrfp_tpu_torch.nn.norms import GlobalBatchNorm2d
from mrfp_tpu_torch.parallel.dist import rank, world
from mrfp_tpu_torch.perturb.np_plus import np_plus
from mrfp_tpu_torch.train.evaluator import SegEvaluator, SlidingEvaluator
from mrfp_tpu_torch.train.state import create_train_state
from mrfp_tpu_torch.train.step import train_step

VARIANTS = ("base", "fused", "accum2", "batch_weighting", "jointwtborder")


def rows(n: int) -> slice:
    """This process's rows of a global batch of ``n``."""
    b = n // world()
    return slice(rank() * b, (rank() + 1) * b)


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()).hexdigest()


def bn_case(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            running_mean: torch.Tensor, running_var: torch.Tensor) -> dict:
    """One train-mode forward and backward of the port's BatchNorm on this
    process's rows of ``x`` (``(out * dy).sum()``): in one process that is
    ``nn.BatchNorm2d`` itself. The weight's and bias's gradients are this
    process's part (the step's all-reduce sums them)."""
    bn = GlobalBatchNorm2d(x.shape[1], eps=1e-5, momentum=0.1).to(x.dtype)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
        bn.running_mean.copy_(running_mean)
        bn.running_var.copy_(running_var)
    bn.train()
    r = rows(x.shape[0])
    xr = x[r].clone().requires_grad_(True)
    out = bn(xr)
    (out * dy[r]).sum().backward()
    return {"out": out.detach(), "dx": xr.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
            "running_mean": bn.running_mean, "running_var": bn.running_var,
            "num_batches_tracked": bn.num_batches_tracked}


def np_plus_case(feat: torch.Tensor, dy: torch.Tensor, seed: int) -> dict:
    """NP+ with draws from a generator seeded ``seed`` on this process's
    rows, forward and the input's gradient."""
    r = rows(feat.shape[0])
    x = feat[r].clone().requires_grad_(True)
    out = np_plus(x, torch.Generator().manual_seed(seed))
    (out * dy[r]).sum().backward()
    return {"out": out.detach(), "dx": x.grad}


def step_cfg(variant: str):
    """The fp32 MRFP+ recipe at rate 1 with ``variant``'s knob."""
    cfg = mrfp_plus_config()
    train = dict(compute_dtype="float32", lr=1.0)
    data = {}
    if variant == "fused":
        train["fuse_bn_stats"] = True
    elif variant == "accum2":
        train["accum_steps"] = 2
    elif variant == "batch_weighting":
        data["batch_weighting"] = True
    elif variant == "jointwtborder":
        data.update(jointwtborder=True, border_window=2)
    elif variant != "base":
        raise ValueError(variant)
    return cfg.replace(train=dataclasses.replace(cfg.train, **train),
                       data=dataclasses.replace(cfg.data, **data))


def _draw_rows(draws, n: int, accum: int):
    """This process's rows of injected NP+ draws: of the batch, or under
    accumulation of each global microbatch (rank r's local microbatch i is
    the r-th part of the global microbatch i)."""
    if accum == 1:
        r = rows(n)
        return tuple(t[r] for t in draws)
    return [tuple(t[rows(t.shape[0])] for t in d) for d in draws]


def step_case(sd: dict, img: torch.Tensor, lbl: torch.Tensor, draws: dict,
              variant: str) -> dict:
    """One fp32 MRFP+ step, all gates on, with injected NP+ draws
    (``draws["np0"]``, ``draws["np1"]``: (alpha, beta_noise) of the global
    batch, or one pair per microbatch under accumulation), from the state
    ``sd``, on this process's rows of the batch. Returns the loss, every
    gradient and the state after the step."""
    cfg = step_cfg(variant)
    model = MRFP(oc_branch=True, hrfp_plus=True)
    model.load_state_dict(sd, strict=True)
    state = create_train_state(model.train(), cfg.train)
    n, accum = img.shape[0], cfg.train.accum_steps
    perturb = PerturbArgs(True, True, True, _draw_rows(draws["np0"], n, accum),
                          _draw_rows(draws["np1"], n, accum))
    r = rows(n)
    loss = train_step(state, img[r].contiguous(), lbl[r].contiguous(), cfg, perturb=perturb)
    return {"loss": float(loss["loss"]),
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def steps_case(imgs: torch.Tensor, lbls: torch.Tensor, seed: int = 3) -> dict:
    """Steps of the MRFP+ recipe with the DSN head from seeded random
    weights, one per batch of ``imgs`` (S, N, H, W, 3), every draw from the
    run's own streams (gates, OC re-draw, NP+, dropout) on this process's
    rows. Returns the losses and the state after them."""
    from mrfp_tpu_torch.cli.train import build_state
    cfg = mrfp_plus_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, use_dsn_aux=True),
                      train=dataclasses.replace(cfg.train, compute_dtype="float32", seed=seed))
    state = build_state(cfg, torch.device("cpu"))
    r = rows(imgs.shape[1])
    losses, gates = [], []
    for img, lbl in zip(imgs, lbls):
        m = train_step(state, img[r].contiguous(), lbl[r].contiguous(), cfg)
        losses.append(float(m["loss"]))
        gates.append((m["gate_oc"], m["gate_np"], m["gate_dec"]))
    return {"losses": losses, "gates": gates,
            "state": {k: v.clone() for k, v in state.model.state_dict().items()}}


def eval_case(sd: dict, length: int = 5, hw=(48, 64)) -> dict:
    """The histograms of ``SegEvaluator`` and ``SlidingEvaluator`` (crop
    32) over a synthetic dataset, each process scoring its stride."""
    model = MRFP()
    model.load_state_dict(sd, strict=True)
    model.eval()
    ds = SyntheticDataset(length=length, hw=hw, seed=5)
    out = {}
    for name, ev in (("seg", SegEvaluator(model, device="cpu")),
                     ("sliding", SlidingEvaluator(model, crop_size=32, tile_batch=4,
                                                  device="cpu"))):
        res = ev.run(ds, log=lambda *a, **k: None, shard_rank=rank(), shard_count=world())
        out[name] = {"hist": torch.from_numpy(np.asarray(res["hist"])),
                     "mean_iu": res["mean_iu"], "scored": res["scored"]}
    return out


def checkpoint_case(directory: str) -> dict:
    """A tiny train state saved with metrics (a best) by every rank into a
    directory of its own, then restored by every rank from rank 0's:
    what each directory holds, and what the restore gave."""
    import json
    import os

    from mrfp_tpu_torch.core.config import TrainConfig
    from mrfp_tpu_torch.train.checkpoint import CheckpointManager

    def state(seed):
        torch.manual_seed(seed)
        st = create_train_state(torch.nn.Linear(3, 2), TrainConfig())
        st.step = 5
        return st

    own = os.path.join(directory, f"ckpt_rank{rank()}")
    saver = CheckpointManager(own, keep=2)
    saver.save(state(0), metrics={"mean_iu": 0.5})
    saver.close()
    written = sorted(os.listdir(own))
    best = os.path.join(own, "best", "metric.json")
    best = json.load(open(best)) if os.path.exists(best) else None
    fresh = state(1)
    reader = CheckpointManager(os.path.join(directory, "ckpt_rank0"), keep=2)
    reader.restore(fresh)
    reader.close()
    return {"written": written, "best": best, "restored_step": fresh.step,
            "weight_equal": bool(torch.equal(fresh.model.weight, state(0).model.weight))}
