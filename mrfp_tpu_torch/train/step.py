"""The train step (mrfp_tpu/train/step.py:28-162, ``accum_steps == 1``).

One SGD step: the batch is cast on the device (uint8 or float NHWC images
to float NCHW, labels to int64); the gates are drawn on the host from the
step's ``gates`` stream; when the stem gate fires the OC buffers are
re-drawn from the ``oc_resample`` stream; then forward, cross-entropy,
backward and the optimizer step. Every draw comes from a stream seeded by
``(seed, step, role)`` (``core/rng.py``), so a resumed run takes the steps
an unbroken one would. The step returns its metrics as device tensors and
never waits for the device.

Knobs of the JAX step that the port does not run yet raise here and name
their ROADMAP item.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from mrfp_tpu_torch.core.config import Config
from mrfp_tpu_torch.core.rng import step_generators
from mrfp_tpu_torch.models.mrfp import PerturbArgs
from mrfp_tpu_torch.ops.dot_stats import bn_stats_fusion
from mrfp_tpu_torch.perturb.oc_branch import oc_maybe_resample
from mrfp_tpu_torch.train.losses import cross_entropy
from mrfp_tpu_torch.train.state import TrainState


def check_supported(cfg: Config) -> None:
    """Raise on a knob whose code path is not ported."""
    if cfg.train.accum_steps > 1:
        raise NotImplementedError("accum_steps > 1: gradient accumulation is "
                                  "ROADMAP item A10")
    extras = {"freq_transform": cfg.data.freq_transform,
              "jointwtborder": cfg.data.jointwtborder,
              "batch_weighting": cfg.data.batch_weighting,
              "use_dsn_aux": cfg.model.use_dsn_aux}
    on = [k for k, v in extras.items() if v]
    if on:
        raise NotImplementedError(f"{', '.join(on)}: the training extras are "
                                  f"ROADMAP item A11")


def draw_perturb(state: TrainState, cfg: Config) -> Optional[PerturbArgs]:
    """This step's gates and NP+ streams; re-draws the OC buffers when the
    stem gate fires. None for a config without perturbation."""
    pc = cfg.perturb
    if not pc.enabled:
        return None
    gens = step_generators(state.seed, state.step)
    u = torch.rand(3, generator=gens["gates"]).tolist()
    gate_oc, gate_np, gate_dec = u[0] < pc.p_oc, u[1] < pc.p_np, u[2] < pc.p_dec
    oc_maybe_resample(state.model, gate_oc, gens["oc_resample"], pc.oc_bn_std)
    return PerturbArgs(gate_oc=gate_oc, gate_np=gate_np, gate_dec=gate_dec,
                       np0=gens["np_l0"], np1=gens["np_l1"])


def autocast_for(cfg: Config, device: torch.device):
    """bf16 autocast when the compute dtype is bfloat16 (parameters stay
    fp32), else nothing."""
    if cfg.train.compute_dtype == "bfloat16":
        return torch.autocast(device.type, dtype=torch.bfloat16)
    if cfg.train.compute_dtype != "float32":
        raise ValueError(f"compute_dtype must be 'bfloat16' or 'float32', got "
                         f"{cfg.train.compute_dtype!r}")
    return contextlib.nullcontext()


def train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
               cfg: Config, perturb: Optional[PerturbArgs] = None,
               impl: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """One SGD step on ``state`` in place; returns ``{"loss", "gate_oc",
    "gate_np", "gate_dec"}`` (the loss a device tensor, the gates bools).

    ``images``: NHWC uint8 or float, ``labels``: NHW integer, both on the
    model's device. ``perturb`` replaces this step's draws (tests and the
    kernel-vs-plain check force the gates and inject the NP+ draws; the OC
    buffers are then used as they are). ``impl="plain"`` runs every resize,
    and with ``cfg.train.fuse_bn_stats`` every fused 1x1, through its plain
    version.
    """
    model = state.model
    device = images.device
    x = images.permute(0, 3, 1, 2).float().contiguous()  # exact for uint8
    labels = labels.long()
    if perturb is None:
        perturb = draw_perturb(state, cfg)
    model.train()
    # fuse_bn_stats: the bottleneck 1x1 + BN pairs take their moments from
    # the product's own sums (mrfp_tpu/train/step.py:225-238)
    fusion = (bn_stats_fusion(impl) if cfg.train.fuse_bn_stats
              else contextlib.nullcontext())
    with autocast_for(cfg, device), fusion:
        logits = model(x, impl=impl, perturb=perturb)
    loss = cross_entropy(logits, labels, cfg.data.ignore_index)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    gates = (perturb.gate_oc, perturb.gate_np, perturb.gate_dec) if perturb else (False,) * 3
    return {"loss": loss.detach(), "gate_oc": gates[0], "gate_np": gates[1],
            "gate_dec": gates[2]}
