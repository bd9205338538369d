"""The RobustNet zoo trainer, PyTorch port (mrfp_tpu/cli/train_zoo.py).

    python -m mrfp_tpu_torch.cli.train_zoo --device cuda --synthetic \
        --trunk resnet-18 --variant D32 --wt-layer 0 0 2 2 2 0 0 --use-wtloss \
        --batch-size 16 --crop-size 768 --max-iter 12

    python -m mrfp_tpu_torch.cli.train_zoo --arch DeepR50V3PlusD \
        --wt-layer 0 0 2 2 2 0 0 --use-wtloss --source gtav --data-root /data

Objective per step (``train/zoo_step.py``): CE(main) + 0.4 CE(DSN aux) +
``--wt-reg-weight`` x the ISW/IRW whitening loss. With ``--use-wtloss`` and
an ISW slot (iw code 2) a statistics phase runs before the loop, and again
from the restored weights on a resume: ``--covstat-batches`` pairs of
differently augmented views of the same images give each instrumented
layer its variance of covariance, k-means (``--clusters``) picks the
sensitive entries, and the frozen masks feed every step. The flags and
their defaults are the JAX trainer's (bf16 on, batch 16, crop 768).

The loop, checkpoints and validation are ``cli.train``'s
(``train/loop.py``, ``train/checkpoint.py``, ``train/evaluator.py``). Every
checkpoint carries the zoo recipe (``run_recipe``: the data, crop, seed,
trunk, variant, ``wt_layer``, ``use_wtloss``, ``use_dsn``), so a zoo
checkpoint never resumes into ``cli.train`` and an MRFP one never resumes
here. ``cli.eval --trunk/--variant --wt-layer ... --ckpt <run>`` (or
``--arch``) evaluates a run; ``cli.export`` takes the same flags.

Every trunk of the JAX zoo trains (``--trunk`` or ``--arch``, the 23
factory names) with every iw code 0-5. Refused: an IRW slot (iw code 1)
with ``--use-wtloss``, which the JAX trainer cannot run either (ROADMAP C6),
and ``--use-wtloss`` with an ISW slot that the trunk does not read (C11).

Data parallelism, one process per card, as ``cli.train`` runs it:

    torchrun --nproc-per-node 8 -m mrfp_tpu_torch.cli.train_zoo --batch-size 16 ...

    python -m mrfp_tpu_torch.cli.train_zoo --num-processes 2 --process-id 0 \
        --coordinator-address 10.0.0.1:29500 ...   # and --process-id 1

``--batch-size`` is the global batch and must divide by the number of
processes. The step is the global batch's (``train/zoo_step.py``: global
BatchNorm and SwitchWhiten statistics, loss and whitening-loss means,
summed gradients). As in the JAX trainer, every process runs the
statistics phase over the same first ``--covstat-batches`` x (batch /
processes) images, in batches of its local size, and then takes rank 0's
masks. Only rank 0 writes the checkpoints, the logs and ``--json-out``;
every rank resumes; validation splits the images across the processes.

Spatial parallelism, as ``cli.train`` runs it (``core/mesh.py``):

    python -m mrfp_tpu_torch.cli.train_zoo --num-processes 4 --spatial-parallel 2 ...

lays the N processes out as a (N/S) x S mesh: the loader is sharded over
the N/S data ranks, the S ranks of a spatial group load the same samples
and each keeps its band of every image's rows, and every map of the step
(SwitchWhiten's and ISW/IRW's statistics, the whitening loss, the DSN
head) is split in bands of rows (``train/zoo_step.py``). ``--batch-size``
is the global batch over the N/S data ranks; the statistics phase's pairs
stay at the JAX trainer's batch over N. S may not exceed the rows of the
trunk's smallest map (``models.deepv3_zoo.deepest_rows``: SE-ResNeXt's is
at stride 32 whatever ``--variant`` says).

Tensor parallelism, as ``cli.train`` runs it (``core/mesh.py``):

    python -m mrfp_tpu_torch.cli.train_zoo --num-processes 4 --model-parallel 2 ...

lays the N processes out as a (N/(M S)) x M x S mesh. The M ranks of a
model group load the same samples and each holds its slice of the
channels of every conv kernel, norm, SwitchWhiten tensor and momentum
buffer that M divides (``weights.shard_model``, JAX's ``state_shardings``;
SwitchWhiten's running buffers are cut by group, ROADMAP C14); what M does
not divide stays whole and computes its whole map on every rank. The
statistics phase runs on the whole model, gathered from the shards, so
its masks are one process's. The checkpoints stay whole: a run resumes at
any M. M must be 1, 2, 4, 8 or 16. The processes join through NCCL, or
through gloo where ``LOCAL_WORLD_SIZE`` (torchrun's, or set by hand) says
that more of them run on the host than it has cards, so that they share
one (``parallel.dist.backend_for``, as every entry point decides it).
``--device cuda`` runs the hand-written kernels and exits non-zero when no
CUDA device is present; it never falls back to the CPU. Exit 75 means the
run was stopped by a signal and can resume.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="mrfp_tpu_torch zoo (RobustNet) trainer")
    p.add_argument("--arch", default=None,
                   help="reference factory name (DeepR50V3PlusD, ...; "
                        "network/deepv3.py:606-779); overrides --trunk/--variant")
    p.add_argument("--trunk", default="resnet-50")
    p.add_argument("--variant", default="D16")
    p.add_argument("--wt-layer", type=int, nargs=7, metavar="W", default=[0] * 7,
                   help="7-slot whitening plan (0 none, 1 IRW, 2 ISW, 3/4 InstanceNorm, "
                        "5 SwitchWhiten)")
    p.add_argument("--use-wtloss", action="store_true",
                   help="ISW whitening regularizer (needs an iw code 2 slot)")
    p.add_argument("--wt-reg-weight", type=float, default=0.6)
    p.add_argument("--relax-denom", type=float, default=0.0)
    p.add_argument("--clusters", type=int, default=50,
                   help="k-means clusters for ISW mask selection "
                        "(network/cov_settings.py:52-82)")
    p.add_argument("--covstat-batches", type=int, default=4,
                   help="ISW statistics phase: number of view-pair batches")
    p.add_argument("--use-dsn", action=argparse.BooleanOptionalAction, default=True,
                   help="auxiliary DSN head on layer3 (zoo default on, "
                        "network/deepv3.py:417-424)")
    p.add_argument("--aux-weight", type=float, default=0.4)
    p.add_argument("--source", default="gtav")
    p.add_argument("--data-root", default="/data")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--crop-size", type=int, default=768)
    p.add_argument("--max-iter", type=int, default=40000)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false",
                   help="fp32 compute with TF32 off")
    p.add_argument("--random-flip", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--color-jitter", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--gaussian-blur", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--scale-range", type=float, nargs=2, default=(0.5, 2.0),
                   metavar=("MIN", "MAX"))
    p.add_argument("--ckpt-every", type=int, default=1000)
    p.add_argument("--eval-every", type=int, default=0)
    p.add_argument("--eval-max-images", type=int, default=None)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--step-timeout", type=float, default=None,
                   help="exit 75 when no step syncs for this many seconds. "
                        "Default: 1800 on cuda, off on cpu; 0 disables")
    p.add_argument("--first-beat-timeout", type=float, default=None,
                   help="window for the first sync (model upload, kernel build, "
                        "statistics phase). Default: max(2x step-timeout, 3600)")
    p.add_argument("--snapshot-every", type=int, default=0,
                   help="host-snapshot the state every N steps for the watchdog's "
                        "emergency checkpoint; see cli.train")
    p.add_argument("--runs-dir", default="./runs")
    p.add_argument("--json-out", default=None,
                   help="also write the result line ({step, preempted, losses, "
                        "run_dir, covstat}) here")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--num-processes", type=int, default=None,
                   help="processes of a data-parallel run, one per card (default: "
                        "torchrun's WORLD_SIZE, else 1)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank (default: torchrun's RANK)")
    p.add_argument("--coordinator-address", default=None,
                   help="host:port of rank 0's rendezvous, or a file:// path "
                        "(default: torchrun's MASTER_ADDR and MASTER_PORT)")
    p.add_argument("--data-parallel", type=int, default=-1,
                   help="the data axis: -1 or the number of processes over "
                        "--spatial-parallel")
    p.add_argument("--spatial-parallel", type=int, default=1,
                   help="split every image's rows over this many processes (a band "
                        "each), as cli.train does")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="split every conv's output channels over this many processes "
                        "(tensor parallelism; the ranks of a model group take the same "
                        "samples)")
    return p.parse_args(argv)


def check_args(args) -> None:
    """Resolve ``--arch`` into ``--trunk``/``--variant`` and raise on what
    the port cannot run: a mesh ``cli.train`` refuses (``mesh_axes``: a
    global batch the data axis cannot share, a model or spatial axis that
    does not divide the processes, a data axis that is not the processes
    left over), a model axis that does not divide 16, an unknown trunk, a
    spatial split finer than the trunk's smallest map, and under
    ``--use-wtloss`` an IRW slot (ROADMAP C6: the JAX trainer fails there
    with an AttributeError) or an ISW slot the trunk does not read (C11:
    the statistics pass gets no map for it, and the JAX trainer fails
    freezing its mask). The statistics phase's batch, the global batch
    over the processes, must be whole too."""
    from mrfp_tpu_torch.cli.train import mesh_axes
    from mrfp_tpu_torch.models.deepv3_zoo import (arch_trunk, check_zoo_trunk, deepest_rows,
                                                  iw_slots)
    if args.arch:
        args.trunk, args.variant = arch_trunk(args.arch)
    nproc, _dp, mp, sp = mesh_axes(args)
    if 16 % mp:
        raise ValueError(f"--model-parallel {mp} must be 1, 2, 4, 8 or 16")
    if args.batch_size % nproc:
        raise ValueError(f"--batch-size {args.batch_size} (the global batch) not divisible "
                         f"by {nproc} processes (the statistics phase's batch)")
    check_zoo_trunk(args.trunk)
    rows = deepest_rows(args.trunk, args.variant, args.crop_size)
    if sp > rows:
        raise ValueError(f"--spatial-parallel {sp} exceeds the {rows} rows of {args.trunk}'s "
                         f"smallest map at crop {args.crop_size}: a rank would hold no row "
                         f"of it")
    unread = [i for i, c in enumerate(args.wt_layer) if c == 2 and i not in iw_slots(args.trunk)]
    if args.use_wtloss and unread:
        raise ValueError(
            f"--use-wtloss with ISW (iw code 2) in wt_layer slot(s) {unread}, which trunk "
            f"{args.trunk!r} does not read (it reads {list(iw_slots(args.trunk))}): the "
            f"statistics pass gets no map for them, and the JAX trainer fails freezing their "
            f"masks (ROADMAP C11); put the ISW codes in read slots, or train without "
            f"--use-wtloss")
    if args.use_wtloss and 1 in args.wt_layer:
        raise ValueError(
            "--use-wtloss with an IRW slot (iw code 1): the statistics pass calls "
            "set_variance_of_covariance on every covariance layer and CovMatrixIRW has "
            "none, so the JAX trainer fails with an AttributeError (ROADMAP C6); use ISW "
            "(code 2), or train the IRW slots without --use-wtloss")


def build_config(args):
    from mrfp_tpu_torch.core.config import Config, MeshConfig
    cfg = Config()
    return cfg.replace(
        mesh=MeshConfig(data_parallel=-1, model_parallel=args.model_parallel or 1,
                        spatial_parallel=args.spatial_parallel or 1),
        model=dataclasses.replace(
            cfg.model, trunk=args.trunk, variant=args.variant, wt_layer=tuple(args.wt_layer),
            use_wtloss=args.use_wtloss, use_dsn_aux=args.use_dsn,
            relax_denom=args.relax_denom, clusters=args.clusters,
            wt_reg_weight=args.wt_reg_weight, hrfp_plus=False),
        perturb=dataclasses.replace(cfg.perturb, enabled=False),
        data=dataclasses.replace(
            cfg.data, source=args.source, batch_size=args.batch_size,
            crop_size=args.crop_size, base_size=args.crop_size,
            random_flip=args.random_flip,
            color_jitter=cfg.data.color_jitter if args.color_jitter else None,
            gaussian_blur=args.gaussian_blur, scale_range=tuple(args.scale_range)),
        train=dataclasses.replace(
            cfg.train, max_iter=args.max_iter, lr=args.lr, seed=args.seed,
            checkpoint_every=args.ckpt_every, log_every=args.log_every,
            compute_dtype="bfloat16" if args.bf16 else "float32"))


def run_recipe(args) -> dict:
    """What a zoo run's checkpoints may be resumed by: the data, the crop,
    the seed and the model (``mode`` "zoo", which no ``cli.train`` recipe
    has, so neither trainer resumes the other's checkpoint)."""
    synthetic = args.synthetic or args.source == "synthetic"
    return {"source": "synthetic" if synthetic else args.source,
            "crop_size": args.crop_size, "seed": args.seed, "mode": "zoo",
            "trunk": args.trunk, "variant": args.variant,
            "wt_layer": [int(c) for c in args.wt_layer], "use_wtloss": bool(args.use_wtloss),
            "use_dsn": bool(args.use_dsn)}


def _zoo_model(cfg):
    from mrfp_tpu_torch.models.deepv3_zoo import DeepV3Plus
    m = cfg.model
    return DeepV3Plus(num_classes=m.num_classes, trunk=m.trunk, variant=m.variant,
                      wt_layer=m.wt_layer, use_dsn=m.use_dsn_aux)


def build_state(cfg, device: torch.device):
    """The zoo model from seeded random weights, its optimizer and schedule.
    Under a model axis (``core.mesh.current_mesh``) the model is this rank's
    shards of the whole one (``weights.shard_model``)."""
    from mrfp_tpu_torch.core.mesh import current_mesh
    from mrfp_tpu_torch.nn.layers import init_random_
    from mrfp_tpu_torch.train.state import create_train_state
    from mrfp_tpu_torch.weights import shard_model
    model = _zoo_model(cfg)
    init_random_(model, torch.Generator().manual_seed(cfg.train.seed))
    return create_train_state(shard_model(model, current_mesh()).to(device), cfg.train)


def whole_model(cfg, model, device: torch.device):
    """``model`` itself, or under a model axis a whole copy of the cut
    ``model`` (``weights.whole_state_dict``: every rank of the model group
    must call it), on which the statistics pass computes what one process
    computes, as the JAX trainer runs it on the whole state before
    ``shard_state``."""
    from mrfp_tpu_torch.core.mesh import current_mesh
    from mrfp_tpu_torch.weights import whole_state_dict
    mesh = current_mesh()
    if mesh.mp == 1:
        return model
    whole = _zoo_model(cfg).to(device)
    whole.load_state_dict(whole_state_dict(model, mesh), strict=True)
    return whole


def build_view_pairs(dataset, n_batches: int, batch_size: int, seed: int
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The statistics phase's inputs (mrfp_tpu/cli/train_zoo.py:145-175):
    pairs of differently augmented views of the same images, fp32 NHWC.
    The per-sample augmentation follows (seed, epoch, index), so the same
    indices fetched under two epochs give two photometric views, the role
    of RobustNet's doubled colour-jitter pipeline (deepv3.py:481-482). An
    augmentation-free pipeline (``--synthetic``) gives equal views, whose
    variance of covariance is 0, so the second view is then an explicit
    photometric jitter drawn from ``seed``."""
    n = min(len(dataset), n_batches * batch_size)
    idx = list(range(n))

    def grab(epoch):
        if hasattr(dataset, "set_epoch"):
            dataset.set_epoch(epoch)
        return [dataset[i] for i in idx]

    va, vb = grab(1000003), grab(1000007)
    rng = np.random.default_rng(seed)
    pairs = []
    for k in range(0, n, batch_size):
        a = np.stack([np.asarray(s["image"], np.float32) for s in va[k:k + batch_size]])
        b = np.stack([np.asarray(s["image"], np.float32) for s in vb[k:k + batch_size]])
        if np.array_equal(a, b):
            scale = rng.uniform(0.8, 1.2, (b.shape[0], 1, 1, 1)).astype(np.float32)
            b = np.clip(b * scale + rng.normal(0.0, 4.0, b.shape), 0, 255)
        pairs.append((a, b.astype(np.float32)))
    return pairs


def statistics_pairs(args, dataset, nproc: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The statistics phase's view pairs, the same on every rank: the first
    ``--covstat-batches`` x (global batch / processes) images in batches of
    that size, as the JAX trainer takes them (its masks depend on the
    process count), with a spatial axis too, where each rank of a spatial
    group then runs its band of them."""
    return build_view_pairs(dataset, args.covstat_batches, args.batch_size // nproc,
                            args.seed)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    check_args(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False "
                         "(use --device cpu to run the plain versions on the CPU)")
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
    if not args.bf16 and device.type == "cuda":
        # fp32 means full fp32: cuDNN convs default to TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    from mrfp_tpu_torch.cli.train import build_dataset
    from mrfp_tpu_torch.core.mesh import create_mesh
    from mrfp_tpu_torch.data.loader import TrainLoader
    from mrfp_tpu_torch.models.deepv3_zoo import build_cov_layers
    from mrfp_tpu_torch.parallel import dist
    from mrfp_tpu_torch.train.checkpoint import CheckpointManager
    from mrfp_tpu_torch.train.loop import run_training_loop
    from mrfp_tpu_torch.train.step import band_batch
    from mrfp_tpu_torch.train.zoo_step import covstat_pass, zoo_train_step
    from mrfp_tpu_torch.utils.experiment import prep_experiment

    cfg = build_config(args)
    rank, nproc = dist.rank(), dist.world()
    mesh = create_mesh(cfg.mesh)
    exp = prep_experiment(cfg, root=args.runs_dir, coordinator=dist.is_coordinator())
    logging.info("zoo experiment %s on %s (process %d of %d, mesh %dx%dx%d)", exp["name"],
                 device, rank, nproc, mesh.dp, mesh.mp, mesh.sp)
    state = build_state(cfg, device)
    ckpt = CheckpointManager(exp["ckpt_dir"], keep=cfg.train.keep_checkpoints,
                             recipe=run_recipe(args))
    if ckpt.restore(state):
        logging.info("resumed from step %d", state.step)
    dataset = build_dataset(args, cfg)
    # the statistics phase reads the (restored) weights, as RobustNet
    # refreshes its masks from the current model, whole
    wt_masks = wt_nrc = None
    covstat = None
    if cfg.model.use_wtloss and 2 in cfg.model.wt_layer:
        cov_layers = build_cov_layers(cfg.model.trunk, cfg.model.wt_layer,
                                      relax_denom=cfg.model.relax_denom,
                                      clusters=cfg.model.clusters)
        pairs = statistics_pairs(args, dataset, nproc)
        t0 = time.perf_counter()
        wt_masks, wt_nrc = covstat_pass(whole_model(cfg, state.model, device), cov_layers,
                                        pairs, cfg, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        covstat = {"seconds": time.perf_counter() - t0, "pairs": len(pairs),
                   "masks": [{"dim": int(layer.dim), "nrc": n}
                             for layer, n in zip(cov_layers, wt_nrc)]}
        logging.info("covstat phase: %d masks from %d view pairs in %.3f s: %s",
                     len(wt_masks), len(pairs), covstat["seconds"], covstat["masks"])
    workers = cfg.data.num_workers if device.type == "cuda" else 0
    # the ranks of a spatial group load the same samples (the data index's
    # shard) and keep their bands
    loader = TrainLoader(dataset, cfg.data.batch_size // mesh.dp, seed=args.seed,
                         num_workers=workers, pin_memory=device.type == "cuda",
                         shard_rank=mesh.data_index, shard_count=mesh.dp)
    writer = exp["writer"]

    def step_fn(st, images, labels):
        if mesh.sp == 1:
            return zoo_train_step(st, images, labels, cfg, wt_masks, wt_nrc, args.aux_weight)
        x, y, hw = band_batch(mesh, images, labels, cfg)
        return zoo_train_step(st, x, y, cfg, wt_masks, wt_nrc, args.aux_weight, hw=hw)

    run_validation = None
    if args.eval_every:
        from mrfp_tpu_torch.train.evaluator import SegEvaluator
        val_dataset = build_dataset(args, cfg, train=False)
        evaluator = SegEvaluator(state.model, num_classes=cfg.model.num_classes,
                                 device=device,
                                 autocast_dtype=torch.bfloat16 if args.bf16 else None,
                                 mesh=mesh)

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
              "losses": losses, "covstat": covstat}
    if mesh.mp > 1:  # what must be one across the model group
        from mrfp_tpu_torch.weights import replicated_digest
        result["replicated_sha256"] = replicated_digest(state.model)
    print(json.dumps(result))
    if args.json_out and dist.is_coordinator():
        with open(args.json_out, "w") as f:
            json.dump(result, f)
    if preempted and step < cfg.train.max_iter:
        logging.warning("preempted at step %d/%d (resumable); exit 75", step,
                        cfg.train.max_iter)
        return 75
    return 0


if __name__ == "__main__":
    sys.exit(main())
