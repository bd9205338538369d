"""The training loop (mrfp_tpu/train/loop.py:30-164).

- the epoch's shuffle and per-sample augmentation RNG follow the step
  (``loader.set_epoch``), so a resumed run replays the order a fresh one
  would;
- batches cross to the device two ahead of the step (``prefetch_to_device``);
- every ``log_every`` steps the loss is fetched (the loop's one sync point),
  logged and written to the metric sinks (``utils/experiment.py``) with the
  learning rate of the next step, images/s, the step's gates and any
  ``loss_*`` terms the step returns (the zoo step's);
- with a watchdog, the first steps of a launch sync eagerly (steps 1, 2, 4,
  ... until ``log_every`` takes over), so the watchdog leaves its set-up
  window after one step;
- ``eval_every`` runs validation, whose metrics feed the best-by-mIoU
  checkpoint rotation;
- a checkpoint every ``checkpoint_every`` steps and at each of the last 20
  (main.py:867-869), and a final one;
- with ``snapshot_every`` and a watchdog, in a one-process run: every N
  steps, at a sync point, the state is copied to host memory and becomes
  the watchdog's emergency save (mrfp_tpu/train/loop.py:51-101);
- SIGTERM/SIGINT finish the step in flight, save, and return ``preempted``,
  so a relaunch resumes from there. With more than one process
  (``parallel/dist.py``) the ranks agree on it at the logged steps, which
  sync anyway, and stop together at the first one after any rank was
  signalled.

Under data parallelism every rank runs the loop on its shard; the loss it
logs is the global batch's and ``batch_size`` (the images/s) the global
batch, and the coordinator alone writes (``utils/experiment.py``,
``train/checkpoint.py``).
"""

from __future__ import annotations

import logging
import signal
import time

import torch

from mrfp_tpu_torch.parallel.dist import all_reduce_sum, world
from mrfp_tpu_torch.train.checkpoint import blob_nbytes


def _stop_now(preempted: bool, step: int, log_every: int, device) -> bool:
    """Whether the run stops after ``step``: one process stops when it is
    signalled; several stop together, at a logged step, once any one was."""
    if world() == 1:
        return preempted
    if step % log_every:
        return False
    return bool(all_reduce_sum(torch.tensor([int(preempted)], device=device)))


def run_training_loop(state, loader, step_fn, cfg, ckpt, writer, device,
                      eval_every: int = 0, run_validation=None, watchdog=None,
                      snapshot_every: int = 0):
    """Drive ``step_fn(state, images, labels) -> metrics`` to
    ``cfg.train.max_iter``. Returns ``(step, preempted, losses)``, where
    ``losses`` maps each step of this run that logged to its loss; the final
    checkpoint is written before it returns.

    ``snapshot_every`` (needs ``watchdog`` and one process; else a warning
    and no snapshots, as in JAX): every N steps, at a sync point, the whole
    state is copied to host memory (``ckpt.host_blob``) and registered as
    the watchdog's emergency hook. When the watchdog fires, its thread
    writes that snapshot as a checkpoint before the exit 75, touching no
    device, so a relaunch loses at most N steps where the scheduled
    checkpoints would lose up to ``checkpoint_every``. Each snapshot's copy
    time and bytes are logged and written as ``train/snapshot_seconds`` and
    ``train/snapshot_bytes``."""
    from mrfp_tpu_torch.data.loader import prefetch_to_device

    log_every = cfg.train.log_every
    max_iter = cfg.train.max_iter
    step = state.step
    steps_per_epoch = max(1, len(loader))
    metrics_for_ckpt = None
    preempted = False
    losses = {}

    def _on_signal(signum, frame):
        nonlocal preempted
        preempted = True
        logging.warning("signal %d: checkpoint-and-exit after this step", signum)

    prev_handlers = [(s, signal.signal(s, _on_signal))
                     for s in (signal.SIGTERM, signal.SIGINT)]
    steps_this_run, next_early_sync = 0, 1
    t_last, steps_since_log = time.perf_counter(), 0
    stopped = False
    if snapshot_every and (watchdog is None or world() > 1):
        logging.warning("snapshot_every ignored (needs a watchdog and a single-process run)")
        snapshot_every = 0
    last_snapshot_step = step

    def _snapshot_if_due():
        nonlocal last_snapshot_step
        if not snapshot_every or step - last_snapshot_step < snapshot_every:
            return
        # at a sync point the step's results exist; copy them now: once the
        # device wedges it is too late
        t0 = time.perf_counter()
        blob = ckpt.host_blob(state)
        seconds = time.perf_counter() - t0
        last_snapshot_step = step
        nbytes = blob_nbytes(blob)
        logging.info("snapshot of step %d to host memory: %d bytes in %.3f s", step, nbytes,
                     seconds)
        writer.add_scalar("train/snapshot_seconds", seconds, step)
        writer.add_scalar("train/snapshot_bytes", nbytes, step)

        def _emergency_save(blob=blob, snap_step=step):
            logging.critical("watchdog: persisting host snapshot of step %d before exit",
                             snap_step)
            ckpt.write_blob(blob)

        watchdog.set_emergency(_emergency_save)
    try:
        while step < max_iter and not stopped:
            loader.set_epoch(step // steps_per_epoch)
            for batch in prefetch_to_device(iter(loader), device):
                metrics = step_fn(state, batch["image"], batch["label"])
                step = state.step
                steps_this_run += 1
                steps_since_log += 1
                if watchdog is not None and steps_this_run == next_early_sync \
                        and steps_this_run <= log_every and step % log_every != 0:
                    next_early_sync *= 2
                    float(metrics["loss"])
                    watchdog.beat()
                    _snapshot_if_due()
                if step % log_every == 0:
                    loss = losses[step] = float(metrics["loss"])  # sync point
                    if watchdog is not None:
                        watchdog.beat()
                    _snapshot_if_due()
                    ips = cfg.data.batch_size * steps_since_log / (time.perf_counter() - t_last)
                    t_last, steps_since_log = time.perf_counter(), 0
                    gates = "".join(c if metrics[f"gate_{k}"] else "-"
                                    for c, k in zip("ond", ("oc", "np", "dec")))
                    logging.info("iter %d loss %.4f  %.2f img/s  gates %s", step, loss, ips,
                                 gates)
                    writer.add_scalar("train/loss", loss, step)
                    writer.add_scalar("train/lr", state.optimizer.param_groups[0]["lr"], step)
                    writer.add_scalar("train/images_per_sec", ips, step)
                    for k in ("gate_oc", "gate_np", "gate_dec"):
                        writer.add_scalar(f"train/{k}", float(metrics[k]), step)
                    for k in sorted(k for k in metrics if k.startswith("loss_")):
                        # the zoo step's terms: loss_main, loss_aux, loss_wt
                        writer.add_scalar(f"train/{k}", float(metrics[k]), step)
                if eval_every and step % eval_every == 0:
                    metrics_for_ckpt = run_validation(state, step)
                    if watchdog is not None:
                        watchdog.beat()
                    t_last, steps_since_log = time.perf_counter(), 0  # eval is not img/s
                if step % cfg.train.checkpoint_every == 0 or step >= max_iter - 20:
                    ckpt.save(state, metrics=metrics_for_ckpt)
                    metrics_for_ckpt = None  # only fresh val scores rotate best
                    last_snapshot_step = step  # durable: a snapshot would repeat it
                stopped = _stop_now(preempted, step, log_every, device)
                if step >= max_iter or stopped:
                    break
    finally:
        for s, h in prev_handlers:
            signal.signal(s, h)
    preempted = stopped
    if eval_every and not preempted:
        metrics_for_ckpt = run_validation(state, step)
    ckpt.save(state, metrics=metrics_for_ckpt)
    ckpt.wait()
    if watchdog is not None:
        watchdog.beat()
        watchdog.stop()
    logging.info("%s at step %d", "preempted (resumable)" if preempted else "done", step)
    return step, preempted, losses
