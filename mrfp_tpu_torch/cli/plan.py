"""Preflight launch planner, PyTorch port (mrfp_tpu/cli/plan.py): what one
step of a data-, tensor- or spatial-parallel ``cli.train`` launch pays,
before the launch.

    python -m mrfp_tpu_torch.cli.plan --trunk resnet-50 --variant D16 \
        --batch-size 8 --data-parallel 2            # on the card(s)

    python -m mrfp_tpu_torch.cli.plan --device cpu --trunk resnet-18 \
        --variant D32 --batch-size 4 --crop-size 64 --data-parallel 2

    python -m mrfp_tpu_torch.cli.plan --device cpu --batch-size 4 \
        --crop-size 64 --data-parallel 1 --spatial-parallel 2

    python -m mrfp_tpu_torch.cli.plan --device cpu --trunk resnet-18 \
        --variant D32 --batch-size 2 --crop-size 64 --data-parallel 1 \
        --model-parallel 2

It builds what ``cli.train`` would run (its config factories, ``build_state``
and ``train_step``) and reports

  - the mesh and each rank's bytes of parameters, momentum and running
    statistics (data and spatial parallelism replicate the state; under
    ``--model-parallel M`` each tensor that ``core.mesh.tp_spec`` shards
    counts its bytes / M, as the JAX planner counts each leaf's shard on
    one device);
  - every collective of one step, rolled up by op with its bytes, and by
    dtype: the gradient's flat ``all_reduce``, the BatchNorm statistics
    forward and backward, NP+'s gathered means, the loss denominators; and
    by process group, the halo rows of spatial parallelism apart from the
    statistics;
  - the step's FLOPs and bytes (roofline inputs),

plus one JSON line with the JAX report's keys (``--json-out`` writes it to
a file too).

The collectives are counted, not parsed: the port issues each of them
explicitly through ``parallel/dist.py``, so N = dp x M x S rank processes
(``torch.multiprocessing``, a file rendezvous) join a process group, lay
out the mesh and take one step of ``cli.train``'s own step on a seeded
synthetic batch, the gates forced on (every collective a step can pay),
under ``parallel/audit.py``'s count. Under data parallelism alone that
step runs at ``AUDIT_CROP`` (64 px): no collective of data parallelism
depends on the crop (``tests/test_torch_plan.py`` holds the rollups at two
crops equal). The halo rows of spatial parallelism are as wide as the
maps, and tensor parallelism gathers whole maps, so with S > 1 or M > 1
the ranks' step runs at ``--crop-size``. By
default the ranks run on the card, through NCCL with a card each, else
sharing it through gloo; ``--device cpu`` runs gloo ranks on the CPU, the
counterpart of the JAX planner's simulated CPU slice.

The work is counted over one data rank's step at ``--crop-size`` in this
process (no group, so the statistics take torch's own BatchNorm; whole
images, the halo rows' recomputation not counted) and scaled to the
global batch. FLOPs come from ``torch.utils.flop_counter``:
the convolutions and products, forward and backward, every tap counted.
XLA's cost analysis counts only the taps that land inside the input, and
elementwise work too, so the JAX planner's figure lies a few percent
under this one at a small crop. Bytes are the sum of each aten op's tensor
inputs and outputs (views excluded), with each resize, kernel or plain
version, taken as one op: its map in and its map out. So the figure does
not depend on the device the pass runs on. It is an upper bound that
assumes no fusion; XLA's ``bytes accessed`` is counted after fusion, so
the two bytes figures do not compare.

The JAX planner's ``--live`` is not ported (ROADMAP A13).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_leaves

from mrfp_tpu_torch.ops import resize

AUDIT_CROP = 64  # the ranks' counted step's crop: the collectives do not depend on it


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="preflight plan: run one step of a data-parallel cli.train launch and "
                    "report its per-step collectives, per-rank state and work")
    p.add_argument("--trunk", default="resnet-50")
    p.add_argument("--variant", default="D16")
    p.add_argument("--mode", default="mrfp+", choices=["mrfp+", "mrfp", "baseline"])
    p.add_argument("--batch-size", type=int, default=16, help="GLOBAL batch size")
    p.add_argument("--crop-size", type=int, default=768)
    p.add_argument("--accum-steps", type=int, default=1)
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--data-parallel", type=int, default=-1,
                   help="ranks of the data axis; -1 takes --devices")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="ranks that split every conv's output channels (cli.train's flag)")
    p.add_argument("--spatial-parallel", type=int, default=1,
                   help="ranks that split each image's rows (cli.train's flag)")
    p.add_argument("--devices", type=int, default=None,
                   help="devices of the planned launch (default: --data-parallel)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the ranks and the work pass run")
    p.add_argument("--json-out", default=None)
    return p.parse_args(argv)


def ranks(args) -> int:
    """The data axis's size; raises on a mesh the port cannot run."""
    sp, mp = args.spatial_parallel, args.model_parallel
    if sp < 1 or mp < 1:
        raise ValueError(f"--spatial-parallel {sp}, --model-parallel {mp}: need at least 1")
    if 16 % mp:
        raise ValueError(f"--model-parallel {mp} must divide every channel count of the "
                         f"model: 1, 2, 4, 8 or 16")
    if args.data_parallel > 0:
        n = args.data_parallel
    elif args.devices is not None:
        n = args.devices // (mp * sp)
    else:
        raise SystemExit("--data-parallel is -1 (fill): pass --devices N or an explicit "
                         "--data-parallel")
    if args.devices is not None and args.devices != n * mp * sp:
        raise ValueError(f"mesh {n}x{mp}x{sp} != {args.devices} devices")
    if n < 1 or args.batch_size % n:
        raise ValueError(f"--batch-size {args.batch_size} (the global batch) not divisible "
                         f"by {n} ranks")
    if (args.batch_size // n) % args.accum_steps:
        raise ValueError(f"the local batch {args.batch_size // n} not divisible by "
                         f"--accum-steps {args.accum_steps}")
    if sp > 1:
        from mrfp_tpu_torch.nn.resnet import deepest_rows
        rows = deepest_rows(args.crop_size, args.variant)
        if sp > rows:
            raise ValueError(f"--spatial-parallel {sp} exceeds the {rows} rows of the smallest "
                             f"map ({args.variant} at crop {args.crop_size})")
    return n


def train_config(args, crop: int):
    """``cli.train``'s config of this launch at ``crop``, every gate's
    probability 1 (``u < 1`` always holds: the step's own draw turns every
    gate on)."""
    import dataclasses

    from mrfp_tpu_torch.cli import train as cli_train
    argv = ["--trunk", args.trunk, "--variant", args.variant, "--mode", args.mode,
            "--batch-size", str(args.batch_size), "--crop-size", str(crop),
            "--accum-steps", str(args.accum_steps),
            "--model-parallel", str(args.model_parallel),
            "--spatial-parallel", str(args.spatial_parallel)] + ([] if args.bf16 else
                                                                 ["--no-bf16"])
    cfg = cli_train.build_config(cli_train.parse_args(argv))
    return cfg.replace(perturb=dataclasses.replace(cfg.perturb, p_oc=1.0, p_np=1.0,
                                                   p_dec=1.0))


def step_batch(n_ranks: int, rank: int, global_batch: int, crop: int, device):
    """This data rank's rows of a seeded synthetic global batch: uint8 NHWC
    images and int64 labels (a strip ignored)."""
    gen = torch.Generator().manual_seed(0)
    img = torch.randint(0, 256, (global_batch, crop, crop, 3), generator=gen,
                        dtype=torch.uint8)
    lbl = torch.randint(0, 19, (global_batch, crop, crop), generator=gen)
    lbl[:, :crop // 8] = 255
    b = global_batch // n_ranks
    rows = slice(rank * b, (rank + 1) * b)
    return img[rows].to(device), lbl[rows].to(device)


def _rank(rank: int, args, n: int, tmp: str) -> None:
    """One rank (a process of its own): join the group, lay out the mesh,
    take one counted step on its samples (and its band of their rows),
    write its collectives to ``tmp/rank<rank>.json``."""
    from mrfp_tpu_torch.cli.train import build_state
    from mrfp_tpu_torch.core.mesh import create_mesh, reset_mesh, spatial_sharding
    from mrfp_tpu_torch.parallel import dist
    from mrfp_tpu_torch.parallel.audit import count_collectives
    from mrfp_tpu_torch.train.step import train_step
    sp, mp = args.spatial_parallel, args.model_parallel
    world = n * mp * sp
    # every rank runs on this host
    dist.initialize_distributed(f"file://{tmp}/rendezvous", world, rank, args.device,
                                backend=dist.backend_for(args.device, world), timeout_s=600)
    try:
        device = dist.local_device(args.device)
        crop = AUDIT_CROP if sp == mp == 1 else args.crop_size
        cfg = train_config(args, crop)
        mesh = create_mesh(cfg.mesh)
        state = build_state(cfg, device)
        img, lbl = step_batch(n, mesh.data_index, args.batch_size, crop, device)
        hw = None if sp == 1 else (crop, crop)
        img, lbl = spatial_sharding(mesh, img), spatial_sharding(mesh, lbl)
        with count_collectives() as log:
            float(train_step(state, img, lbl, cfg, hw=hw)["loss"])  # the step has finished
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump([vars(c) for c in log], f)
    finally:
        reset_mesh()
        torch.distributed.destroy_process_group()


def run_ranks(args, n: int) -> list:
    """Run the ``n`` x ``--model-parallel`` x ``--spatial-parallel`` ranks of
    this plan and return each one's collectives
    (``parallel.audit.Collective``), in rank order. The ranks of a data or
    model group issue the same collectives; those of a spatial group the
    same calls, their halos as large as their bands read."""
    import torch.multiprocessing as tmp_mp

    from mrfp_tpu_torch.parallel.audit import Collective
    world = n * args.model_parallel * args.spatial_parallel
    with tempfile.TemporaryDirectory() as tmp:
        tmp_mp.start_processes(_rank, args=(args, n, tmp), nprocs=world, start_method="spawn")
        got = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                got.append([Collective(**{**c, "shape": tuple(c["shape"])})
                            for c in json.load(f)])
    def calls(log):  # a halo is as large as the rows its rank's band reads
        return [(c.op, c.group, c.kind, c.dtype, None if c.kind == "halo" else c.shape)
                for c in log]

    if any(calls(g) != calls(got[0]) for g in got):
        raise RuntimeError("plan: the ranks issued different collectives")
    return got


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class OpBytes(TorchDispatchMode):
    """Adds up the bytes of every aten op's tensor inputs and outputs,
    views excluded, in ``total``; each resize (``ops/resize.py``) counts
    as one op, its map in and its map out, whichever version runs."""

    total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.total += _nbytes((args, kwargs, out))
        return out

    def unit(self, fn, x, *args):
        with _disable_current_modes():
            out = fn(x, *args)
        self.total += _nbytes((x, out))
        return out

    def __enter__(self):
        resize._BYTES = self
        return super().__enter__()

    def __exit__(self, *exc):
        resize._BYTES = None
        return super().__exit__(*exc)


def _shard_bytes(named, place: dict, mp: int) -> int:
    """The bytes of ``(key, tensor)`` pairs on one rank: a tensor that
    ``place`` shards counts 1/``mp`` of its bytes (JAX's
    ``_bytes_per_chip``)."""
    return sum(t.numel() * t.element_size() // (mp if place.get(k) is not None else 1)
               for k, t in named)


def work(args, n: int) -> dict:
    """One data rank's step at ``--crop-size`` in this process, counted: its
    FLOPs and bytes times ``n``, and a rank's state bytes (under
    ``--model-parallel`` the shards' of the whole state)."""
    from torch.utils.flop_counter import FlopCounterMode

    from mrfp_tpu_torch.cli.train import build_state
    from mrfp_tpu_torch.train.step import train_step
    from mrfp_tpu_torch.weights import tp_placement
    device = torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda" \
        else torch.device("cpu")
    cfg = train_config(args, args.crop_size)
    state = build_state(cfg, device)
    img, lbl = step_batch(n, 0, args.batch_size, args.crop_size, device)
    flops, moved = FlopCounterMode(display=False), OpBytes()
    with flops, moved:
        float(train_step(state, img, lbl, cfg)["loss"])
    model, mp = state.model, args.model_parallel
    place = tp_placement(model.state_dict(), mp)
    params = list(model.named_parameters())
    momentum = [(k, t) for k, p in params for t in tree_leaves(state.optimizer.state[p])
                if isinstance(t, torch.Tensor)]
    return {"params": _shard_bytes(params, place, mp),
            "momentum": _shard_bytes(momentum, place, mp),
            "batch_stats": _shard_bytes([(k, b) for k, b in model.named_buffers()
                                         if "running" in k], place, mp),
            "fp32_grad_set_bytes": sum(p.numel() * 4 for p in model.parameters()
                                       if p.requires_grad),
            "flops": float(flops.get_total_flops() * n), "bytes": float(moved.total * n)}


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    n = ranks(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False "
                         "(use --device cpu to plan on the CPU)")
    from mrfp_tpu_torch.parallel.audit import (summarize, summarize_by_dtype,
                                                summarize_by_group)
    sp, mp = args.spatial_parallel, args.model_parallel
    log = run_ranks(args, n)[0]
    colls, by_dtype, by_group = summarize(log), summarize_by_dtype(log), summarize_by_group(log)
    w = work(args, n)
    platform = "gpu" if args.device == "cuda" else "cpu"
    report = {
        "mesh": {"data": n, "model": mp, "spatial": sp},
        "devices": n * mp * sp,
        "platform": platform,
        "global_batch": args.batch_size,
        "crop": args.crop_size,
        "accum_steps": args.accum_steps,
        "per_chip_bytes": {k: w[k] for k in ("params", "momentum", "batch_stats")},
        "fp32_grad_set_bytes": w["fp32_grad_set_bytes"],
        "collectives_per_step": {k: {"count": v["count"], "mbytes": round(v["bytes"] / 1e6, 2)}
                                 for k, v in sorted(colls.items())},
        "collectives_by_dtype": {op: {dt: {"count": v["count"], "bytes": v["bytes"]}
                                      for dt, v in sorted(d.items())}
                                 for op, d in sorted(by_dtype.items())},
        "collectives_by_group": {g: {k: {"count": v["count"], "bytes": v["bytes"]}
                                     for k, v in sorted(d.items())}
                                 for g, d in sorted(by_group.items())},
        "flops_per_step": w["flops"],
        "hbm_bytes_per_step": w["bytes"],
    }

    def mb(b: float) -> str:
        return f"{b / 1e6:,.1f} MB"

    print(f"mesh {report['mesh']} over {n * mp * sp} {platform} devices; global batch "
          f"{args.batch_size} @ {args.crop_size}x{args.crop_size}"
          + (f", {args.accum_steps} microbatches" if args.accum_steps > 1 else ""))
    print(f"per-chip state: params {mb(w['params'])}, momentum {mb(w['momentum'])}, "
          f"BN stats {mb(w['batch_stats'])}")
    if not colls:
        print("collectives/step: none (single-device program)")
    for op, v in sorted(colls.items()):
        hint = {"all-reduce": "grad + norm-stat sync",
                "broadcast": "rank 0's values to every rank"}.get(op, "")
        split = ", ".join(f"{dt} x{d['count']} {mb(d['bytes'])}"
                          for dt, d in sorted(by_dtype[op].items()))
        print(f"collectives/step: {op:19s} x{v['count']:<4d} {mb(v['bytes']):>12s}  {hint} "
              f"({split})")
    for g, d in sorted(by_group.items()):
        print(f"collectives/step over the {g} group: " + ", ".join(
            f"{kind} x{v['count']} {mb(v['bytes'])}" for kind, v in sorted(d.items())))
    ar = colls.get("all-reduce", {"bytes": 0})
    if ar["bytes"]:
        print(f"grad-sync check: all-reduce total {mb(ar['bytes'])} vs fp32 grad set "
              f"{mb(w['fp32_grad_set_bytes'])}")
    print(f"counted/step: {w['flops'] / 1e12:.2f} TFLOP, {w['bytes'] / 1e9:.2f} GB of op "
          f"inputs and outputs, unfused (arithmetic intensity "
          f"{w['flops'] / max(w['bytes'], 1):.0f} flop/byte)")
    line = json.dumps(report)
    print(line)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
