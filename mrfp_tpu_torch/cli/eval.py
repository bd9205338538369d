"""Multi-domain evaluation entry point (main.py:876-913), PyTorch port.

    python -m mrfp_tpu_torch.cli.eval --ckpt model.pth --data-root /data \
        --domains bdd100k cityscapes synthia mapillary gtav

    python -m mrfp_tpu_torch.cli.eval --device cuda --synthetic \
        --synthetic-hw 1024 2048 --max-images 4

    python -m mrfp_tpu_torch.cli.eval --ckpt runs/<name> --data-root /data

    python -m mrfp_tpu_torch.cli.eval --device cuda --trunk resnet-18 \
        --variant D32 --wt-layer 0 0 2 2 2 0 0 --ckpt runs/<zoo run>

Reads a reference PyTorch ``.pth`` checkpoint, or what the port's
``cli.train`` or ``cli.train_zoo`` writes: a ``step_<N>.pt``, or a run directory (its latest
checkpoint; ``runs/<name>/ckpt/best`` for the best by mIoU). ``--arch`` or
``--wt-layer`` selects the zoo's ``DeepV3Plus`` (with ``--use-dsn``, on by
default, as its trainer). Without
``--ckpt`` the model has seeded random weights. ``--device cuda`` runs the
hand-written kernels and exits non-zero when no CUDA device is present; it
never falls back to the CPU.

``--spatial-parallel S`` splits every image's rows over S processes
(mrfp_tpu/cli/eval.py:70,218-222; ``core/mesh.py``), the batch-1 serving
case for an image whose activations exceed one card: each process runs the
model's forward on its band, fetching the conv halos from its neighbours, and
the histograms are summed. The processes come from torchrun or the flags
``--num-processes S --process-id R --coordinator-address``; without either,
``cli.eval`` starts the S ranks itself (``torch.multiprocessing``, a file
rendezvous): on the cards through NCCL when there is one each, else
sharing the card (or the CPU) through gloo. Ranks started otherwise that
share a card say so with ``LOCAL_WORLD_SIZE``, as every entry point reads
it (``parallel.dist.backend_for``). Rank 0 prints and writes the
results. The zoo models (``--arch``, ``--wt-layer``) take it too, their
SwitchWhiten and instance whitening statistics spanning the bands.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Dict, Optional, Sequence

import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="mrfp_tpu_torch multi-domain eval")
    p.add_argument("--ckpt", default=None,
                   help="reference .pth, or a step_<N>.pt or run directory of the "
                        "port's cli.train (default: seeded random weights)")
    p.add_argument("--data-root", default="/data")
    p.add_argument("--domains", nargs="+",
                   default=["bdd100k", "cityscapes", "synthia", "mapillary", "gtav"],
                   help="domain names, or 'all' for the 5-domain reference sweep")
    p.add_argument("--trunk", default="resnet-50")
    p.add_argument("--variant", default="D16")
    add_zoo_args(p)
    p.add_argument("--eval-size", type=int, default=1536)
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-hw", type=int, nargs=2, default=(256, 512),
                   metavar=("H", "W"), help="synthetic image size (smoke tests)")
    p.add_argument("--strict-pairs", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="drop images whose label size mismatches (reference "
                        "behavior, main.py:894); --no-strict-pairs crops to "
                        "the common extent")
    p.add_argument("--json-out", default=None,
                   help="also write the results dict to this file")
    p.add_argument("--bucket", type=int, default=None,
                   help="pad eval shapes up to multiples of N (logits deviate "
                        "near padded borders). Default: exact shapes, the "
                        "reference protocol")
    p.add_argument("--eval-batch", type=int, default=1,
                   help="group N same-shape images per forward (exact-shape "
                        "protocol only; ignored with --bucket)")
    p.add_argument("--step-timeout", type=float, default=None,
                   help="watchdog: exit 75 (restartable) when no image batch "
                        "syncs within this window. Default: 1800 s on cuda, "
                        "off on cpu; 0 disables")
    p.add_argument("--corrupt", choices=["fog", "rain"], default=None,
                   help="apply a synthetic adverse-weather corruption to every "
                        "eval image (mrfp_tpu/data/weather.py)")
    p.add_argument("--severity", type=int, default=2,
                   help="corruption severity 1..4 (with --corrupt)")
    p.add_argument("--parity", action="store_true",
                   help="declare this run a reference-parity measurement: "
                        "refuses any protocol deviation (--bucket, --eval-batch "
                        ">1, --dtype bfloat16, --no-strict-pairs, --corrupt)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                   help="compute dtype. float32 (TF32 off) is the reference "
                        "parity protocol; bfloat16 runs the forward under "
                        "autocast, logits stay float32")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--spatial-parallel", type=int, default=1,
                   help="split every image's rows over this many processes (the "
                        "batch-1 case of an image beyond one card's memory)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="processes of a --spatial-parallel run (default: torchrun's "
                        "WORLD_SIZE, else cli.eval starts them itself)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank (default: torchrun's RANK)")
    p.add_argument("--coordinator-address", default=None,
                   help="host:port of rank 0's rendezvous, or a file:// path")
    return p.parse_args(argv)


def check_parity_protocol(args) -> None:
    """--parity: fail fast on any flag that breaks the reference protocol."""
    violations = []
    if args.bucket is not None:
        violations.append("--bucket (padded borders deviate ~0.04 mIoU)")
    if args.eval_batch != 1:
        violations.append("--eval-batch >1 (near-tie argmax flips)")
    if args.dtype != "float32":
        violations.append("--dtype bfloat16 (borderline argmaxes differ)")
    if not args.strict_pairs:
        violations.append("--no-strict-pairs (reference drops mismatches)")
    if args.corrupt:
        violations.append("--corrupt (synthetic weather is not the "
                          "reference's rendered-dataset protocol)")
    if violations:
        raise SystemExit("--parity refuses protocol deviations:\n  "
                         + "\n  ".join(violations))


def add_zoo_args(p: argparse.ArgumentParser) -> None:
    """The flags that select a zoo model (mrfp_tpu/cli/eval.py:32-41)."""
    p.add_argument("--arch", default=None,
                   help="evaluate a zoo (cli.train_zoo) model instead of MRFP: a reference "
                        "factory name (network/deepv3.py:606-779), e.g. DeepR50V3PlusD; "
                        "overrides --trunk/--variant")
    p.add_argument("--wt-layer", type=int, nargs=7, default=None, metavar="W",
                   help="whitening plan of a zoo model (must match its training); "
                        "selects the zoo model with --trunk/--variant")
    p.add_argument("--use-dsn", action=argparse.BooleanOptionalAction, default=True,
                   help="a zoo model carries the DSN head (its checkpoint's keys); "
                        "the eval forward does not run it")


def build_model(args, generator=None):
    """The eval model the flags name, on the CPU: a zoo ``DeepV3Plus`` when
    ``--arch`` or ``--wt-layer`` is given (mrfp_tpu/cli/eval.py:114-125),
    else ``MRFP``; seeded random weights from ``generator``. Other CLIs
    with fewer flags read absent zoo flags as the MRFP model."""
    from mrfp_tpu_torch.models import build_mrfp
    from mrfp_tpu_torch.models.deepv3_zoo import DeepV3Plus, get_net
    from mrfp_tpu_torch.nn.layers import init_random_
    arch, wt = getattr(args, "arch", None), getattr(args, "wt_layer", None)
    if arch is None and wt is None:
        return build_mrfp("cpu", generator=generator, trunk=args.trunk,
                          variant=args.variant)
    wt = tuple(wt) if wt else (0,) * 7
    use_dsn = getattr(args, "use_dsn", True)
    model = get_net(arch, wt_layer=wt, use_dsn=use_dsn) if arch else \
        DeepV3Plus(trunk=args.trunk, variant=args.variant, wt_layer=wt, use_dsn=use_dsn)
    if generator is not None:
        init_random_(model, generator)
    return model


def load_model(args, device: torch.device):
    from mrfp_tpu_torch.train.checkpoint import find_checkpoint
    from mrfp_tpu_torch.weights import load_torch_checkpoint

    gen = None if args.ckpt else torch.Generator().manual_seed(0)
    model = build_model(args, gen)
    if args.ckpt:
        load_torch_checkpoint(model, find_checkpoint(args.ckpt))
    return model.to(device)


def _dataset(args, domain: str):
    if args.synthetic:
        from mrfp_tpu_torch.data import SyntheticDataset
        ds = SyntheticDataset(length=4, hw=tuple(args.synthetic_hw))
        ds.name = domain
    else:
        # the dataset catalog imports PIL, so it loads only here, for real data
        from mrfp_tpu_torch.data.datasets import DATASETS, VAL_SPLITS, domain_root
        ds = DATASETS[domain](root=domain_root(args.data_root, domain),
                              split=VAL_SPLITS[domain], train=False,
                              eval_size=args.eval_size)
    if args.corrupt:
        from mrfp_tpu_torch.data.weather import CorruptedDataset
        ds = CorruptedDataset(ds, args.corrupt, args.severity)
    return ds


def check_spatial(args) -> None:
    """Raise where ``--spatial-parallel`` cannot run: a process count other
    than S."""
    sp = args.spatial_parallel
    if sp < 1:
        raise ValueError(f"--spatial-parallel {sp}: need at least 1")
    if sp == 1:
        return
    nproc = args.num_processes if args.num_processes is not None else \
        int(os.environ.get("WORLD_SIZE", sp))
    if nproc != sp:
        raise ValueError(f"--spatial-parallel {sp} with {nproc} processes: the eval splits "
                         f"one image over all of them")


def _spawned_rank(rank: int, argv: list, sp: int, tmp: str) -> None:
    """One rank that ``cli.eval`` started itself: the ``sp`` ranks run on
    this host (``parallel.dist.backend_for`` reads it)."""
    os.environ["LOCAL_WORLD_SIZE"] = str(sp)
    main(list(argv) + ["--num-processes", str(sp), "--process-id", str(rank),
                       "--coordinator-address", f"file://{tmp}/rendezvous",
                       "--json-out", os.path.join(tmp, "results.json")])


def _spawn(argv: list, args) -> Dict[str, dict]:
    """Run the ``--spatial-parallel`` ranks as processes of this one's and
    return rank 0's results."""
    import tempfile

    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_spawned_rank, args=(argv, args.spatial_parallel, tmp),
                           nprocs=args.spatial_parallel, start_method="spawn")
        with open(os.path.join(tmp, "results.json")) as f:
            results = json.load(f)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(results, f)
    return results


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.parity:
        check_parity_protocol(args)
    check_spatial(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False "
                         "(use --device cpu to run the plain versions on the CPU)")
    if args.spatial_parallel == 1:
        return _evaluate(args, torch.device(args.device), None)
    if args.num_processes is None and "WORLD_SIZE" not in os.environ:
        return _spawn(list(sys.argv[1:] if argv is None else argv), args)
    from mrfp_tpu_torch.core.config import MeshConfig
    from mrfp_tpu_torch.core.mesh import create_mesh, reset_mesh
    from mrfp_tpu_torch.parallel import dist
    dist.initialize_distributed(args.coordinator_address, args.num_processes,
                                args.process_id, args.device,
                                backend=dist.backend_for(args.device))
    try:
        mesh = create_mesh(MeshConfig(data_parallel=1, spatial_parallel=args.spatial_parallel))
        return _evaluate(args, dist.local_device(args.device), mesh)
    finally:
        reset_mesh()
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _evaluate(args, device: torch.device, mesh) -> Dict[str, dict]:
    from mrfp_tpu_torch.parallel import dist
    speak = dist.is_coordinator()
    if args.dtype == "float32" and device.type == "cuda":
        # fp32 parity means full fp32: cuDNN convs default to TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    # armed before the first device contact: model upload and the kernel
    # build count toward the first-beat window
    from mrfp_tpu_torch.utils.watchdog import watchdog_from_arg
    watchdog = watchdog_from_arg(args.step_timeout, accelerator=device.type == "cuda")
    model = load_model(args, device)

    from mrfp_tpu_torch.train.evaluator import SegEvaluator
    evaluator = SegEvaluator(
        model, strict_pairs=args.strict_pairs, bucket=args.bucket,
        eval_batch=args.eval_batch, device=device,
        autocast_dtype=torch.bfloat16 if args.dtype == "bfloat16" else None, mesh=mesh)
    domains = args.domains
    if domains == ["all"]:
        domains = ["bdd100k", "cityscapes", "synthia", "mapillary", "gtav"]
    results = {}
    for domain in domains:
        res = evaluator.run(_dataset(args, domain), max_images=args.max_images,
                            heartbeat=watchdog.beat if watchdog else None,
                            log=print if speak else (lambda *a, **k: None))
        if speak:
            print(f"Number of images dropped: {res['dropped']}")
        results[domain] = {
            "mean_iu": res["mean_iu"], "acc": res["acc"], "fwavacc": res["fwavacc"],
            "images": res["scored"], "pixels": int(res["hist"].sum()),
            "images_per_s": res["scored"] / res["seconds"],
            "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                       else "cpu")}
    if watchdog is not None:
        watchdog.stop()
    if speak:
        print(json.dumps(results, indent=2))
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump(results, f)
    return results


if __name__ == "__main__":
    main()
