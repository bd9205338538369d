"""The train step (mrfp_tpu/train/step.py:28-162).

One SGD step: the batch is cast on the device (uint8 or float NHWC images
to float NCHW, labels to int64); the gates are drawn on the host from the
step's ``gates`` stream; when the stem gate fires the OC buffers are
re-drawn from the ``oc_resample`` stream; then forward, loss, backward and
the optimizer step. Every draw comes from a stream seeded by ``(seed, step,
role)`` (``core/rng.py``), so a resumed run takes the steps an unbroken one
would. The step returns its metrics as device tensors and never waits for
the device.

The training extras, each off by default, in the order they act:

- ``cfg.data.freq_transform``: HPF / LPF / PHOT of the NHWC fp32 batch
  (``perturb/fft_style.py``);
- ``cfg.data.batch_weighting``: class weights of the CE from the label
  histogram of the whole batch, also under accumulation;
- ``cfg.data.jointwtborder``: the border-relaxed CE replaces the CE; the
  window halves and boundary pixels weigh 2 once the step passes
  ``reduce_border_iter`` (-1: never);
- ``cfg.model.use_dsn_aux``: plus 0.4 x the CE of the DSN head's logits
  against the labels nearest-resized to their size (the nearest kernel on
  the card).

``cfg.train.accum_steps = N`` splits the batch mb-major (image i goes to
microbatch i % N) and runs the N microbatches forward and backward in turn,
so the BN running statistics move once per microbatch, in order. The loss
is the mean of the microbatch losses and the gradient the mean of their
gradients; one optimizer step follows. The gates and the OC re-draw stay
once per step; the NP+ and dropout streams fold in the microbatch index.

With more than one process (``parallel/dist.py``, one per card) each rank
steps on its shard of the global batch and the step is the global batch's,
as the JAX package's is under a sharded batch: BatchNorm, NP+ and the loss
denominators reduce over every rank (``nn/norms.py``,
``perturb/np_plus.py``, ``train/losses.py``), the per-sample draws are the
global batch's rows for this rank, and after the backward (the last
microbatch's, under accumulation) one flat ``all_reduce`` per dtype sums
the gradients. Summed, not averaged: each rank's loss is its local sum
over the global denominator, so the sum is the global loss's gradient.
The gates and the OC re-draw come from streams every rank shares, so the
ranks skip the same branches and keep identical parameters. The
microbatch split ``i % accum`` of the local shard is JAX's split of the
global batch when the local batch divides by ``accum``, which the step
requires.

Under spatial parallelism (``core/mesh.py``, ``sp > 1``) ``images`` and
``labels`` are this rank's band of rows of its data rank's samples, and
``hw`` the images' global size: the forward and the loss run inside one
band scope, the CE's numerator is the band's and its denominator the
world's, and the gradient all-reduce over the world sums the bands' and
the samples' parts alike. Every extra runs on bands: the border-relaxed
CE fetches the label rows its window reads (``train/losses.py``), the
class weights' histogram is a world sum, the fused BN statistics fetch
the rows a strided 1x1 keeps (``nn/layers.py::conv1x1_with_stats``), and
the FFT transforms, which act on whole images, run on the whole images
before the band is cut (``band_batch``; every rank of the spatial group
then transforms the same images, ``sp`` times the work of one).

Under tensor parallelism (``core/mesh.py``, ``mp > 1``) the model is cut
by ``weights.shard_model`` and the ranks of a model group take the same
images (or bands): the forward computes each rank's slice of the
channels (``models/mrfp.py``), the logits and the loss are whole on every
rank of the group, and the gradient all-reduce and the logged loss sum
over the replica group only, the ranks that share the model index. The
gates, the OC re-draw and the dropout stream come from the step's
shared seeds, so the replicated parameters and buffers stay equal bit for
bit across a model group.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import torch

from mrfp_tpu_torch.core.config import Config
from mrfp_tpu_torch.core.mesh import Mesh, active_bands, bands, current_mesh, spatial_sharding
from mrfp_tpu_torch.core.rng import device_generator, role_seed, step_generators
from mrfp_tpu_torch.models.mrfp import PerturbArgs
from mrfp_tpu_torch.ops.dot_stats import bn_stats_fusion
from mrfp_tpu_torch.ops.resize import resize_nearest
from mrfp_tpu_torch.parallel.dist import all_reduce_grads, all_reduce_sum
from mrfp_tpu_torch.perturb.fft_style import apply_freq_transform
from mrfp_tpu_torch.perturb.oc_branch import oc_maybe_resample
from mrfp_tpu_torch.train.losses import (batch_class_weights, cross_entropy,
                                         relaxed_cross_entropy)
from mrfp_tpu_torch.train.state import TrainState
from mrfp_tpu_torch.utils.profiling import span

DSN_WEIGHT = 0.4  # network/deepv3.py:570-577


def draw_perturb(state: TrainState, cfg: Config) -> Optional[PerturbArgs]:
    """This step's gates and NP+ streams; re-draws the OC buffers when the
    stem gate fires. None for a config without perturbation. Under
    accumulation ``np0``/``np1`` are lists, one generator per microbatch."""
    pc = cfg.perturb
    if not pc.enabled:
        return None
    gens = step_generators(state.seed, state.step)
    u = torch.rand(3, generator=gens["gates"]).tolist()
    gate_oc, gate_np, gate_dec = u[0] < pc.p_oc, u[1] < pc.p_np, u[2] < pc.p_dec
    oc_maybe_resample(state.model, gate_oc, gens["oc_resample"], pc.oc_bn_std)
    accum = max(1, cfg.train.accum_steps)
    if accum == 1:
        np0, np1 = gens["np_l0"], gens["np_l1"]
    else:
        np0, np1 = ([torch.Generator().manual_seed(role_seed(state.seed, state.step, role, i))
                     for i in range(accum)] for role in ("np_l0", "np_l1"))
    return PerturbArgs(gate_oc=gate_oc, gate_np=gate_np, gate_dec=gate_dec,
                       np0=np0, np1=np1)


def autocast_for(cfg: Config, device: torch.device):
    """bf16 autocast when the compute dtype is bfloat16 (parameters stay
    fp32), else nothing."""
    if cfg.train.compute_dtype == "bfloat16":
        return torch.autocast(device.type, dtype=torch.bfloat16)
    if cfg.train.compute_dtype != "float32":
        raise ValueError(f"compute_dtype must be 'bfloat16' or 'float32', got "
                         f"{cfg.train.compute_dtype!r}")
    return contextlib.nullcontext()


def _pick(value, i: int):
    """Microbatch ``i``'s entry of a per-microbatch list; anything else is
    shared by every microbatch."""
    return value[i] if isinstance(value, list) else value


def _loss(out, labels: torch.Tensor, cfg: Config, class_weights: Optional[torch.Tensor],
          reduce_now: bool, impl: Optional[str]) -> torch.Tensor:
    """The step's objective on one (micro)batch's forward output."""
    d = cfg.data
    logits, aux = out if isinstance(out, tuple) else (out, None)
    if d.jointwtborder:
        loss = relaxed_cross_entropy(logits, labels, cfg.model.num_classes, d.ignore_index,
                                     d.border_window, reduce_now, d.strict_border_class)
    else:
        loss = cross_entropy(logits, labels, d.ignore_index, class_weights)
    if aux is not None:
        loss = loss + DSN_WEIGHT * dsn_cross_entropy(aux, labels, d.ignore_index, impl)
    return loss


def dsn_cross_entropy(aux: torch.Tensor, labels: torch.Tensor, ignore_index: int,
                      impl: Optional[str] = None) -> torch.Tensor:
    """CE of the DSN head's logits against the labels nearest-resized to
    their size (network/deepv3.py:570-576; the nearest kernel on the card);
    in a spatial scope both are bands, and the size the global one."""
    scope = active_bands()
    size = aux.shape[2:] if scope is None else scope.global_hw(aux)
    small = resize_nearest(labels[:, None].float(), size=size, impl=impl)
    return cross_entropy(aux, small[:, 0].long(), ignore_index)


def band_batch(mesh: Mesh, images: torch.Tensor, labels: torch.Tensor, cfg: Config
               ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[int, int]]:
    """This rank's band of rows of a batch that its spatial group holds
    whole (NHWC images, NHW labels), and the images' global (h, w), for
    ``train_step(..., hw=, transformed=True)``. ``cfg.data.freq_transform``
    acts on whole images, so it is applied here, before the band is cut:
    every rank of the group transforms the same images."""
    hw = (int(images.shape[1]), int(images.shape[2]))
    if cfg.data.freq_transform:
        images = apply_freq_transform(images.float(), cfg.data.freq_transform)
    return spatial_sharding(mesh, images), spatial_sharding(mesh, labels), hw


def train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
               cfg: Config, perturb: Optional[PerturbArgs] = None,
               impl: Optional[str] = None,
               dropout: Union[torch.Tensor, List[torch.Tensor], None] = None,
               hw: Optional[Tuple[int, int]] = None, transformed: bool = False
               ) -> Dict[str, torch.Tensor]:
    """One SGD step on ``state`` in place; returns ``{"loss", "gate_oc",
    "gate_np", "gate_dec"}`` (the loss a device tensor, the gates bools).

    ``images``: NHWC uint8 or float, ``labels``: NHW integer, both on the
    model's device. ``perturb`` replaces this step's draws (tests and the
    kernel-vs-plain check force the gates and inject the NP+ draws; the OC
    buffers are then used as they are); ``dropout`` injects the DSN head's
    keep masks. Under accumulation either may carry a list with one entry
    per microbatch in its ``np0``/``np1`` or in itself. ``impl="plain"``
    runs every resize, and with ``cfg.train.fuse_bn_stats`` every fused
    1x1, through its plain version. ``hw``: the images' global (h, w) when
    they are this rank's band of rows (spatial parallelism).
    ``transformed``: ``cfg.data.freq_transform`` was already applied to the
    whole images (``band_batch``); a band cannot be transformed alone.
    """
    with span("train.step", step=state.step):
        model = state.model
        device = images.device
        spatial = hw is not None and current_mesh().sp > 1
        freq = cfg.data.freq_transform if not transformed else None
        if spatial and freq:
            raise ValueError("the FFT transforms act on whole images: cut the band after them "
                             "(train.step.band_batch) and pass transformed=True")
        accum = max(1, cfg.train.accum_steps)
        if images.shape[0] % accum:
            raise ValueError(f"batch {images.shape[0]} (this process's) not divisible by "
                             f"accum_steps {accum}")
        # fp32 (exact for uint8); fp64 images stay fp64 (a reference step)
        f = torch.float64 if images.dtype == torch.float64 else torch.float32
        if freq:
            x = apply_freq_transform(images.float(), freq).to(f)
            x = x.permute(0, 3, 1, 2).contiguous()
        else:
            x = images.permute(0, 3, 1, 2).to(f).contiguous()
        labels = labels.long()
        if perturb is None:
            perturb = draw_perturb(state, cfg)
        class_weights = (batch_class_weights(labels, cfg.model.num_classes, cfg.data.ignore_index)
                         if cfg.data.batch_weighting else None)
        reduce_now = cfg.data.reduce_border_iter != -1 and state.step > cfg.data.reduce_border_iter
        if dropout is None and cfg.model.use_dsn_aux:
            dropout = [device_generator(state.seed, state.step, "dropout", device,
                                        None if accum == 1 else i) for i in range(accum)]
        model.train()
        total = None
        for i in range(accum):
            mb = slice(i, None, accum)  # with accum 1 a view of the whole batch: no copy
            mb_perturb = None if perturb is None else dataclasses.replace(
                perturb, np0=_pick(perturb.np0, i), np1=_pick(perturb.np1, i))
            xi, li = x[mb].contiguous(), labels[mb].contiguous()
            # fuse_bn_stats: the bottleneck 1x1 + BN pairs take their moments
            # from the product's own sums (mrfp_tpu/train/step.py:225-238)
            fusion = (bn_stats_fusion(impl) if cfg.train.fuse_bn_stats
                      else contextlib.nullcontext())
            with span("train.forward", microbatch=i), \
                    bands(*hw) if spatial else contextlib.nullcontext():
                with autocast_for(cfg, device), fusion:
                    out = model(xi, impl=impl, perturb=mb_perturb, dropout=_pick(dropout, i),
                                **({} if hw is None else {"hw": hw}))
                loss = _loss(out, li, cfg, class_weights, reduce_now, impl)
            if i == 0:
                # after the first forward is queued, so the host's pass over
                # every parameter overlaps the device's work
                state.optimizer.zero_grad(set_to_none=True)
            with span("train.backward"):
                loss.backward()
            total = loss.detach() if total is None else total + loss.detach()
        replica = current_mesh().replica
        all_reduce_grads(model.parameters(), replica)
        if accum > 1:
            # the mean of the microbatch means, as the JAX package's scan takes it
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(accum)
            total = total / accum
        total = all_reduce_sum(total, replica)  # the global batch's loss on every rank
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        gates = (perturb.gate_oc, perturb.gate_np, perturb.gate_dec) if perturb else (False,) * 3
        return {"loss": total, "gate_oc": gates[0], "gate_np": gates[1], "gate_dec": gates[2]}
