"""Training entry point, PyTorch port (mrfp_tpu/cli/train.py).

    python -m mrfp_tpu_torch.cli.train --device cuda --synthetic \
        --batch-size 8 --crop-size 768 --max-iter 6

    python -m mrfp_tpu_torch.cli.train --source gtav --data-root /data \
        --max-iter 40000 --batch-size 16

The paper's MRFP+ recipe by default: R50-D16 (``--trunk`` takes any of the
nine ResNet trunks; resnet-101's deep stem takes ``--mode baseline`` only,
as in JAX: ROADMAP C8), all three gates live, SGD
with poly decay, bf16 autocast with fp32 parameters (``--no-bf16``: fp32
with TF32 off). Every single-device flag of the JAX trainer is taken:
``--accum-steps``, the training extras (``--use-dsn``,
``--freq-transform``, ``--batch-weighting``, ``--jointwtborder`` with its
border knobs), the data flags, and ``--oc-conditional`` as a no-op. The
bf16 momentum, as in JAX, has no flag: ``cfg.train.momentum_dtype``.
``--snapshot-every N`` keeps a host copy of the state every N steps for the
watchdog to persist when a step wedges. Scalars go to the run's
``metrics.jsonl`` and to TensorBoard events under its ``tb/``. Without a
checkpoint in its run directory the model starts from seeded random
weights; with one it resumes from the latest, and refuses one written by
another recipe (``run_recipe``).
``--device cuda`` runs the hand-written kernels and exits non-zero when no
CUDA device is present; it never falls back to the CPU. Exit 75 means the
run was stopped by a signal and can resume.

Data parallelism, one process per card (``parallel/dist.py``):

    torchrun --nproc-per-node 8 -m mrfp_tpu_torch.cli.train --batch-size 16 ...

    python -m mrfp_tpu_torch.cli.train --num-processes 2 --process-id 0 \
        --coordinator-address 10.0.0.1:29500 ...   # and --process-id 1

``--batch-size`` is the global batch, as in the JAX trainer: it must divide
by the number of processes, each of which loads and steps on its share.
The step is the global batch's (global BatchNorm, NP+ and loss, summed
gradients), so N processes train what one does on the same batch.
``--device cpu`` runs the processes on gloo. Only rank 0 writes the
checkpoints, the best record and the logs; every rank resumes. Validation
splits the images across the processes and merges their histograms.

Spatial parallelism (``core/mesh.py``): ``--spatial-parallel S`` with N
processes lays them out as a (N/S) x S mesh. The S ranks of a spatial group
load the same samples (the data loader is sharded over the N/S data
ranks), and each keeps its band of every image's rows; every map of the
step is split in bands of rows, the convs, pools and resizes fetching
their halo rows from the neighbours. ``--data-parallel`` may name N/S.
Every extra composes with it: ``--jointwtborder`` fetches the label rows
its window reads, and ``--freq-transform`` runs on each sample's whole
image before the band is cut (each rank of a spatial group repeats it).
Refused: an S above the rows of the trunk's deepest map.

Tensor parallelism (``core/mesh.py``): ``--model-parallel M`` lays the N
processes out as a (N/(M S)) x M x S mesh, JAX's device order. The M ranks
of a model group load the same samples (and bands) and each holds its
slice of the channels of every conv kernel, BN affine and statistic and
momentum buffer (``weights.shard_model``, JAX's ``state_shardings``); each
conv gathers its whole input map over the group and computes its slice of
output channels. The checkpoints stay whole. ``--data-parallel`` may name
N/(M S); any other value raises JAX's ValueError. M must divide every
channel count of the trunk and heads (1, 2, 4, 8 or 16).

    python -m mrfp_tpu_torch.cli.train --device cpu --synthetic --trunk resnet-18 \
        --variant D32 --crop-size 64 --batch-size 2 --num-processes 2 \
        --process-id R --coordinator-address file:///tmp/rdv --model-parallel 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
from typing import Optional, Sequence, Tuple

import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="mrfp_tpu_torch trainer")
    p.add_argument("--source", default="gtav",
                   help="training domain (gtav|synthia|cityscapes|synthetic; "
                        "'+'-join to concatenate)")
    p.add_argument("--data-root", default="/data")
    p.add_argument("--synthetic", action="store_true",
                   help="train on generated data (no datasets needed)")
    p.add_argument("--trunk", default="resnet-50")
    p.add_argument("--variant", default="D16")
    p.add_argument("--mode", default="mrfp+", choices=["mrfp+", "mrfp", "baseline"])
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--crop-size", type=int, default=768)
    p.add_argument("--max-iter", type=int, default=40000)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false",
                   help="fp32 compute with TF32 off")
    p.add_argument("--ckpt-every", type=int, default=1000)
    p.add_argument("--eval-every", type=int, default=0,
                   help="run validation every N iters; 0 = off. Feeds the "
                        "best-by-mIoU checkpoint rotation")
    p.add_argument("--eval-max-images", type=int, default=None)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--step-timeout", type=float, default=None,
                   help="exit 75 when no step syncs for this many seconds. "
                        "Default: 1800 on cuda, off on cpu; 0 disables")
    p.add_argument("--first-beat-timeout", type=float, default=None,
                   help="window for the first sync (model upload, kernel "
                        "build). Default: max(2x step-timeout, 3600)")
    p.add_argument("--runs-dir", default="./runs")
    p.add_argument("--json-out", default=None,
                   help="also write {step, preempted, losses, run_dir} here "
                        "(losses: this run's logged steps, every --log-every)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="split each step's batch into N sequential microbatches "
                        "(activations stay microbatch-sized; effective batches "
                        "beyond one card's memory)")
    p.add_argument("--oc-conditional", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="accepted for the JAX trainer's command lines; a no-op "
                        "here: both forms compute the same values, and the "
                        "host-drawn gates already skip the OC halves a step "
                        "does not use")
    p.add_argument("--use-dsn", action="store_true",
                   help="auxiliary DSN head on layer3 (0.4-weighted CE)")
    p.add_argument("--freq-transform", default=None, choices=[None, "hpf", "lpf", "phot"],
                   help="FFT batch transform on the device (dataloaders.py:24-79)")
    p.add_argument("--random-flip", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--color-jitter", action=argparse.BooleanOptionalAction, default=True,
                   help="--no-color-jitter disables the b/c/s/h jitter "
                        "(main.py:413), e.g. for tasks where absolute color "
                        "carries the label")
    p.add_argument("--gaussian-blur", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--scale-range", type=float, nargs=2, default=(0.5, 2.0),
                   metavar=("MIN", "MAX"))
    p.add_argument("--class-uniform-pct", type=float, default=0.0,
                   help="fraction of train crops biased toward rare-class "
                        "centroids (reference CLASS_UNIFORM_PCT, config.py:53)")
    p.add_argument("--batch-weighting", action="store_true",
                   help="per-batch rare-class CE upweighting (reference "
                        "BATCH_WEIGHTING, config.py:56)")
    p.add_argument("--jointwtborder", action="store_true",
                   help="border-relaxed CE (reference config.py:121): any class "
                        "within a (2*border+1)^2 window is acceptable near label "
                        "borders; target built on the device "
                        "(train/losses.relaxed_cross_entropy)")
    p.add_argument("--border-window", type=int, default=1,
                   help="relaxation half-window (reference BORDER_WINDOW)")
    p.add_argument("--reduce-border-iter", type=int, default=-1,
                   help="after this iteration the window halves and boundary "
                        "pixels weight 2 (reference REDUCE_BORDER_ITER); -1 = never")
    p.add_argument("--strict-border-class", type=int, nargs="*", default=None,
                   help="class ids that keep exact one-hot targets (reference "
                        "STRICT_BORDER_CLASS)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="processes of a data-parallel run, one per card (default: "
                        "torchrun's WORLD_SIZE, else 1)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank (default: torchrun's RANK)")
    p.add_argument("--coordinator-address", default=None,
                   help="host:port of rank 0's rendezvous, or a file:// path "
                        "(default: torchrun's MASTER_ADDR and MASTER_PORT)")
    p.add_argument("--data-parallel", type=int, default=None,
                   help="the data axis: -1 or the number of processes over "
                        "--spatial-parallel")
    p.add_argument("--spatial-parallel", type=int, default=None,
                   help="split every image's rows over this many processes (a band "
                        "each, the conv halos fetched from the neighbours): for "
                        "resolutions whose activations exceed one card's memory")
    p.add_argument("--snapshot-every", type=int, default=0,
                   help="every N steps, at a sync point, copy the state to host memory "
                        "for the watchdog to persist if the device wedges (a relaunch "
                        "then loses at most N steps); needs the watchdog "
                        "(--step-timeout) and one process, else ignored with a warning")
    p.add_argument("--model-parallel", type=int, default=None,
                   help="split every conv's output channels over this many processes "
                        "(tensor parallelism; the ranks of a model group take the same "
                        "samples)")
    return p.parse_args(argv)


def mesh_axes(args) -> Tuple[int, int, int, int]:
    """The run's processes (``--num-processes``, else torchrun's, else 1)
    and its data, model and spatial axes ``(nproc, dp, mp, sp)``; raises
    where ``--model-parallel`` x ``--spatial-parallel`` does not divide the
    processes, an explicit ``--data-parallel`` is not the processes left
    over (JAX's ``mesh dp x mp x sp != n``), or the global batch does not
    divide over the data axis. ``cli.train_zoo`` takes the same flags."""
    nproc = args.num_processes if args.num_processes is not None else \
        int(os.environ.get("WORLD_SIZE", 1))
    if nproc < 1:
        raise ValueError(f"--num-processes {nproc}: need at least 1")
    mp = args.model_parallel or 1
    sp = args.spatial_parallel or 1
    if sp < 1 or mp < 1 or nproc % (mp * sp):
        raise ValueError(f"--spatial-parallel {sp}" + (f" x --model-parallel {mp}" if mp != 1
                                                       else "")
                         + f" does not divide {nproc} processes")
    dp = nproc // (mp * sp)
    if args.data_parallel not in (None, -1) and args.data_parallel != dp:
        raise ValueError(f"mesh {args.data_parallel}x{mp}x{sp} != {nproc} processes")
    if args.batch_size % dp:
        raise ValueError(f"--batch-size {args.batch_size} (the global batch) not divisible "
                         f"by the {dp} ranks of the data axis")
    return nproc, dp, mp, sp


def check_args(args) -> None:
    """Raise on a flag whose code path the port does not have, on a global
    batch the processes cannot share, and on a spatial split finer than
    the smallest map."""
    _nproc, _dp, mp, sp = mesh_axes(args)
    from mrfp_tpu_torch.nn.resnet import check_trunk, deepest_rows
    check_trunk(args.trunk)  # the nine ResNets; the zoo's others raise JAX's ValueError
    if 16 % mp:  # the channel counts' divisor: 48 (bot_fine), 64, ...; ResNeXt's 32 groups
        raise ValueError(f"--model-parallel {mp} must divide every channel count of the "
                         f"model: 1, 2, 4, 8 or 16")
    rows = deepest_rows(args.crop_size, args.variant)
    if sp > rows:
        raise ValueError(f"--spatial-parallel {sp} exceeds the {rows} rows of the smallest "
                         f"map ({args.variant} at crop {args.crop_size}): a rank would hold "
                         f"no row of it")


def build_config(args):
    from mrfp_tpu_torch.core.config import (MeshConfig, baseline_config, mrfp_config,
                                            mrfp_plus_config)
    cfg = {"mrfp+": mrfp_plus_config, "mrfp": mrfp_config,
           "baseline": baseline_config}[args.mode]()
    return cfg.replace(
        mesh=MeshConfig(data_parallel=-1, model_parallel=args.model_parallel or 1,
                        spatial_parallel=args.spatial_parallel or 1),
        model=dataclasses.replace(cfg.model, trunk=args.trunk, variant=args.variant,
                                  use_dsn_aux=args.use_dsn),
        data=dataclasses.replace(
            cfg.data, source=args.source, batch_size=args.batch_size,
            crop_size=args.crop_size, base_size=args.crop_size,
            freq_transform=args.freq_transform, random_flip=args.random_flip,
            color_jitter=cfg.data.color_jitter if args.color_jitter else None,
            gaussian_blur=args.gaussian_blur, scale_range=tuple(args.scale_range),
            class_uniform_pct=args.class_uniform_pct,
            batch_weighting=args.batch_weighting, jointwtborder=args.jointwtborder,
            border_window=args.border_window, reduce_border_iter=args.reduce_border_iter,
            strict_border_class=(tuple(args.strict_border_class)
                                 if args.strict_border_class else None)),
        train=dataclasses.replace(cfg.train, max_iter=args.max_iter, lr=args.lr,
                                  seed=args.seed, accum_steps=args.accum_steps,
                                  checkpoint_every=args.ckpt_every,
                                  log_every=args.log_every,
                                  compute_dtype="bfloat16" if args.bf16 else "float32"))


def run_recipe(args) -> dict:
    """What a run's checkpoints may be resumed by, beside the run name's
    knobs: the data (the source, or synthetic), the crop, the seed, the
    mode and, for ``--use-dsn``, the DSN head (it changes the state_dict;
    a run without it keeps the recipe it had before the head was ported).
    Not ``max_iter``: an extended run resumes."""
    synthetic = args.synthetic or args.source == "synthetic"
    recipe = {"source": "synthetic" if synthetic else args.source,
              "crop_size": args.crop_size, "seed": args.seed, "mode": args.mode}
    if args.use_dsn:
        recipe["use_dsn"] = True
    return recipe


def build_dataset(args, cfg, train: bool = True):
    if args.synthetic or args.source == "synthetic":
        from mrfp_tpu_torch.data import SyntheticDataset
        if train:
            return SyntheticDataset(length=args.batch_size * 8,
                                    hw=(args.crop_size, args.crop_size))
        return SyntheticDataset(length=4, hw=(args.crop_size, args.crop_size), seed=7)
    # the dataset catalog imports PIL, so it loads only here, for real data
    from mrfp_tpu_torch.data.datasets import (DATASETS, TRAIN_SPLITS, VAL_SPLITS,
                                              ConcatDataset, domain_root)
    parts = []
    for src in args.source.split("+"):  # '+'-joined sources concatenate (main.py:821)
        parts.append(DATASETS[src](
            root=domain_root(args.data_root, src),
            split=(TRAIN_SPLITS if train else VAL_SPLITS)[src], train=train,
            base_size=cfg.data.base_size, crop_size=cfg.data.crop_size, seed=args.seed,
            random_flip=cfg.data.random_flip, color_jitter=cfg.data.color_jitter,
            scale_range=cfg.data.scale_range, gaussian_blur=cfg.data.gaussian_blur,
            class_uniform_pct=cfg.data.class_uniform_pct,
            class_uniform_classes=cfg.data.class_uniform_classes))
        if not train:
            return parts[0]  # validate on the first source's val split
    return parts[0] if len(parts) == 1 else ConcatDataset(parts)


def build_state(cfg, device: torch.device):
    """The model from seeded random weights (OC buffers drawn from seed+1,
    as the JAX trainer does), its optimizer and schedule, at step 0. Under
    a model axis (``core.mesh.current_mesh``) the model is this rank's
    shards of the whole one (``weights.shard_model``)."""
    from mrfp_tpu_torch.core.mesh import current_mesh
    from mrfp_tpu_torch.models import build_mrfp
    from mrfp_tpu_torch.perturb.oc_branch import oc_init
    from mrfp_tpu_torch.train.state import create_train_state
    from mrfp_tpu_torch.weights import shard_model

    m = cfg.model
    model = build_mrfp("cpu", generator=torch.Generator().manual_seed(cfg.train.seed),
                       num_classes=m.num_classes, trunk=m.trunk, variant=m.variant,
                       wt_layer=m.wt_layer, oc_branch=cfg.perturb.enabled,
                       hrfp_plus=m.hrfp_plus, np_std=cfg.perturb.np_std,
                       np_scale=cfg.perturb.np_scale,
                       oc_scales_enc=cfg.perturb.oc_scales_enc,
                       oc_scales_dec=cfg.perturb.oc_scales_dec,
                       use_dsn=m.use_dsn_aux)
    if cfg.perturb.enabled:
        model.load_state_dict(oc_init(torch.Generator().manual_seed(cfg.train.seed + 1),
                                      cfg.perturb.oc_bn_std), strict=False)
    model = shard_model(model, current_mesh())
    return create_train_state(model.to(device), cfg.train)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    check_args(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False "
                         "(use --device cpu to run the plain versions on the CPU)")
    # armed before the first device contact: the rendezvous, model upload
    # and the kernel build count toward the first-beat window
    from mrfp_tpu_torch.utils.watchdog import watchdog_from_arg
    watchdog = watchdog_from_arg(args.step_timeout, args.first_beat_timeout,
                                 accelerator=args.device == "cuda")
    from mrfp_tpu_torch.parallel import dist
    # before any other device contact: it picks this process's card
    dist.initialize_distributed(args.coordinator_address, args.num_processes,
                                args.process_id, args.device,
                                backend=dist.backend_for(args.device))
    try:
        return _train(args, dist.local_device(args.device), watchdog)
    finally:
        from mrfp_tpu_torch.core.mesh import reset_mesh
        reset_mesh()
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _train(args, device: torch.device, watchdog) -> int:
    from mrfp_tpu_torch.parallel import dist
    if not args.bf16 and device.type == "cuda":
        # fp32 means full fp32: cuDNN convs default to TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = build_config(args)
    from mrfp_tpu_torch.train.step import band_batch, train_step

    from mrfp_tpu_torch.data.loader import TrainLoader
    from mrfp_tpu_torch.train.checkpoint import CheckpointManager
    from mrfp_tpu_torch.utils.experiment import prep_experiment

    from mrfp_tpu_torch.core.mesh import create_mesh
    rank, nproc = dist.rank(), dist.world()
    mesh = create_mesh(cfg.mesh)
    exp = prep_experiment(cfg, root=args.runs_dir, coordinator=dist.is_coordinator())
    logging.info("experiment %s on %s (process %d of %d, mesh %dx%dx%d)", exp["name"], device,
                 rank, nproc, mesh.dp, mesh.mp, mesh.sp)
    state = build_state(cfg, device)
    ckpt = CheckpointManager(exp["ckpt_dir"], keep=cfg.train.keep_checkpoints,
                             recipe=run_recipe(args))
    if ckpt.restore(state):
        logging.info("resumed from step %d", state.step)
    # the host makes the batches; on the CPU the workers would only take
    # cores from the step itself
    workers = cfg.data.num_workers if device.type == "cuda" else 0
    # the ranks of a spatial or model group load the same samples (the data
    # index's shard) and keep their bands: the host work is repeated mp x sp
    # times
    loader = TrainLoader(build_dataset(args, cfg), cfg.data.batch_size // mesh.dp,
                         seed=args.seed, num_workers=workers,
                         pin_memory=device.type == "cuda", shard_rank=mesh.data_index,
                         shard_count=mesh.dp)
    writer = exp["writer"]

    def step_fn(st, images, labels):
        if mesh.sp == 1:
            return train_step(st, images, labels, cfg)
        x, y, hw = band_batch(mesh, images, labels, cfg)
        return train_step(st, x, y, cfg, hw=hw, transformed=True)

    run_validation = None
    if args.eval_every:
        from mrfp_tpu_torch.train.evaluator import SegEvaluator
        val_dataset = build_dataset(args, cfg, train=False)
        evaluator = SegEvaluator(
            state.model, num_classes=cfg.model.num_classes, device=device,
            autocast_dtype=torch.bfloat16 if args.bf16 else None, mesh=mesh)

        def run_validation(st, step):
            st.model.eval()
            # every data rank scores its stride of the images (its spatial
            # group the bands of each); the merged histogram gives every
            # rank the same mIoU
            res = evaluator.run(val_dataset, max_images=args.eval_max_images,
                                log=lambda *a, **k: None,
                                heartbeat=watchdog.beat if watchdog else None,
                                shard_rank=mesh.data_index, shard_count=mesh.dp)
            logging.info("iter %d val mean_iu %.5f acc %.5f", step, res["mean_iu"],
                         res["acc"])
            writer.add_scalar("val/mean_iu", res["mean_iu"], step)
            writer.add_scalar("val/acc", res["acc"], step)
            return {"mean_iu": res["mean_iu"], "acc": res["acc"]}

    from mrfp_tpu_torch.train.loop import run_training_loop
    try:
        step, preempted, losses = run_training_loop(
            state, loader, step_fn, cfg, ckpt, writer, device,
            eval_every=args.eval_every, run_validation=run_validation, watchdog=watchdog,
            snapshot_every=args.snapshot_every)
    finally:
        ckpt.close()
        writer.close()
        logging.getLogger("").removeHandler(exp["log_handler"])
        exp["log_handler"].close()
    result = {"step": step, "preempted": preempted, "run_dir": exp["exp_dir"],
              "losses": losses}
    print(json.dumps(result))
    if args.json_out and dist.is_coordinator():
        with open(args.json_out, "w") as f:
            json.dump(result, f)
    if preempted and step < cfg.train.max_iter:
        # resumable-but-incomplete must not look like success
        logging.warning("preempted at step %d/%d (resumable); exit 75", step,
                        cfg.train.max_iter)
        return 75
    return 0


if __name__ == "__main__":
    sys.exit(main())
