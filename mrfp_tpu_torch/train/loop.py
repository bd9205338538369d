"""The training loop (mrfp_tpu/train/loop.py:30-164).

- the epoch's shuffle and per-sample augmentation RNG follow the step
  (``loader.set_epoch``), so a resumed run replays the order a fresh one
  would;
- batches cross to the device two ahead of the step (``prefetch_to_device``);
- every ``log_every`` steps the loss is fetched (the loop's one sync point),
  logged and written to the JSONL stream with images/s and the step's gates;
- with a watchdog, the first steps of a launch sync eagerly (steps 1, 2, 4,
  ... until ``log_every`` takes over), so the watchdog leaves its set-up
  window after one step;
- ``eval_every`` runs validation, whose metrics feed the best-by-mIoU
  checkpoint rotation;
- a checkpoint every ``checkpoint_every`` steps and at each of the last 20
  (main.py:867-869), and a final one;
- SIGTERM/SIGINT finish the step in flight, save, and return ``preempted``,
  so a relaunch resumes from there. With more than one process
  (``parallel/dist.py``) the ranks agree on it at the logged steps, which
  sync anyway, and stop together at the first one after any rank was
  signalled.

Under data parallelism every rank runs the loop on its shard; the loss it
logs is the global batch's and ``batch_size`` (the images/s) the global
batch, and the coordinator alone writes (``utils/experiment.py``,
``train/checkpoint.py``).

TensorBoard events and ``snapshot_every`` are not ported (ROADMAP A13).
"""

from __future__ import annotations

import logging
import signal
import time

import torch

from mrfp_tpu_torch.parallel.dist import all_reduce_sum, world


def _stop_now(preempted: bool, step: int, log_every: int, device) -> bool:
    """Whether the run stops after ``step``: one process stops when it is
    signalled; several stop together, at a logged step, once any one was."""
    if world() == 1:
        return preempted
    if step % log_every:
        return False
    return bool(all_reduce_sum(torch.tensor([int(preempted)], device=device)))


def run_training_loop(state, loader, step_fn, cfg, ckpt, writer, device,
                      eval_every: int = 0, run_validation=None, watchdog=None):
    """Drive ``step_fn(state, images, labels) -> metrics`` to
    ``cfg.train.max_iter``. Returns ``(step, preempted, losses)``, where
    ``losses`` maps each step of this run that logged to its loss; the final
    checkpoint is written before it returns."""
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
                if step % log_every == 0:
                    loss = losses[step] = float(metrics["loss"])  # sync point
                    if watchdog is not None:
                        watchdog.beat()
                    ips = cfg.data.batch_size * steps_since_log / (time.perf_counter() - t_last)
                    t_last, steps_since_log = time.perf_counter(), 0
                    gates = "".join(c if metrics[f"gate_{k}"] else "-"
                                    for c, k in zip("ond", ("oc", "np", "dec")))
                    logging.info("iter %d loss %.4f  %.2f img/s  gates %s", step, loss, ips,
                                 gates)
                    writer.add_scalar("train/loss", loss, step)
                    writer.add_scalar("train/images_per_sec", ips, step)
                    for k in ("gate_oc", "gate_np", "gate_dec"):
                        writer.add_scalar(f"train/{k}", float(metrics[k]), step)
                if eval_every and step % eval_every == 0:
                    metrics_for_ckpt = run_validation(state, step)
                    if watchdog is not None:
                        watchdog.beat()
                    t_last, steps_since_log = time.perf_counter(), 0  # eval is not img/s
                if step % cfg.train.checkpoint_every == 0 or step >= max_iter - 20:
                    ckpt.save(state, metrics=metrics_for_ckpt)
                    metrics_for_ckpt = None  # only fresh val scores rotate best
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
