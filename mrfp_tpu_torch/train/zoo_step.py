"""The train step of the DeepV3Plus zoo (mrfp_tpu/train/zoo_step.py;
network/deepv3.py:548-585):

  total = CE(main) + aux_weight * CE(dsn, labels nearest-resized to its size)
          [+ wt_reg_weight * the whitening loss over the collected maps]

and the ISW statistics phase, ``covstat_pass``: pairs of augmented views
of the same images run through the eval-mode model, the variance of
covariance accumulates per instrumented layer (deepv3.py:478-545), and the
masks are frozen on the host and handed to the step as device tensors.

With more than one process (``parallel/dist.py``) the step is the global
batch's, as the JAX package's is under a sharded batch, and as
``train/step.py``'s: BatchNorm and SwitchWhiten's batch statistics, the
loss denominators and the whitening loss's batch mean reduce over every
rank, the DSN dropout mask is the global batch's rows, one flat
``all_reduce`` per dtype sums the gradients, and the returned losses are
the global batch's on every rank. The statistics pass runs on every rank
over the same view pairs in eval mode (no collective), and rank 0's masks
and counts then go to every rank, so no rank can freeze other masks.

Under spatial parallelism (``core/mesh.py``, ``sp > 1``) ``images`` and
``labels`` are this rank's band of rows of its data rank's samples and
``hw`` their global size: the forward and the losses run in one band
scope (the CE's and the DSN CE's numerators the band's, their
denominators the replica group's, the world without a model axis; the
whitening loss as ``train/losses.py`` takes it on bands), and the replica
group's sums give the global batch's losses and gradient. The statistics pass runs each view on bands too, with the
spatial group's sums of the maps' ``f f^T``; its pairs stay at the JAX
trainer's local batch, the global batch over the process count (not over
the data axis), so the masks are those of JAX launched on as many
processes.

Under tensor parallelism (``core/mesh.py``, ``mp > 1``) the model is this
rank's shards (``weights.shard_model``) and the ranks of a model group
take the same samples and rows: the forward runs in a channel scope
(``DeepV3Plus.forward``), the whitening maps reach the loss whole, and
the denominators, the gradient and the logged losses reduce over the
replica group (the ranks that share the model index), as
``train/step.py``'s do. The DSN keep mask is drawn for every channel and
sliced, so the ranks of a model group drop what one process drops. The
statistics pass runs on a whole model (``cli.train_zoo`` gathers it), so
its masks are one process's.

As in the JAX step, the whitening loss takes margin 0 for every map, where
``models.deepv3_zoo.whitening_loss_from_cov`` passes each layer's own
margin; the two differ only with ``relax_denom`` > 0 (ROADMAP C7). The step
updates ``state`` in place with the port's SGD and poly schedule
(``train/state.py``) and never waits for the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import contextlib

import numpy as np
import torch

from mrfp_tpu_torch.core.config import Config
from mrfp_tpu_torch.core.mesh import bands, current_mesh, spatial_sharding
from mrfp_tpu_torch.core.rng import device_generator
from mrfp_tpu_torch.models.deepv3_zoo import covstat_update
from mrfp_tpu_torch.parallel.dist import all_reduce_grads, all_reduce_sum, broadcast, world
from mrfp_tpu_torch.train.losses import cross_entropy, instance_whitening_loss
from mrfp_tpu_torch.train.state import TrainState
from mrfp_tpu_torch.train.step import DSN_WEIGHT, autocast_for, dsn_cross_entropy
from mrfp_tpu_torch.utils.profiling import span


def zoo_train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
                   cfg: Config, wt_masks: Optional[Sequence[torch.Tensor]] = None,
                   wt_nrc: Optional[Sequence[float]] = None,
                   aux_weight: float = DSN_WEIGHT, impl: Optional[str] = None,
                   dropout: Union[torch.Tensor, torch.Generator, None] = None,
                   hw: Optional[Tuple[int, int]] = None) -> Dict[str, object]:
    """One SGD step of the zoo objective on ``state`` in place. ``images``
    NHWC uint8 or float, ``labels`` NHW integer, on the model's device.
    Returns ``{"loss", "loss_main", ["loss_aux"], ["loss_wt"]}`` as device
    tensors (the global batch's on every rank), and the three gates of the
    loop's log, always off.
    ``dropout`` injects the DSN head's keep mask (the parity tests give
    JAX's; on a band, the band's rows of the global mask); by default it
    comes from the step's ``dropout`` stream. ``impl="plain"`` runs every
    resize through its plain version. ``hw``: the images' global (h, w)
    when they are this rank's band of rows (spatial parallelism)."""
    with span("train.step", step=state.step):
        model = state.model
        device = images.device
        # fp32 (exact for uint8); fp64 images stay fp64 (a reference step)
        f = torch.float64 if images.dtype == torch.float64 else torch.float32
        x = images.permute(0, 3, 1, 2).to(f).contiguous()
        labels = labels.long()
        if dropout is None and model.use_dsn:
            dropout = device_generator(state.seed, state.step, "dropout", device)
        ignore = cfg.data.ignore_index
        model.train()
        spatial = hw is not None and current_mesh().sp > 1
        with span("train.forward", microbatch=0), \
                bands(*hw) if spatial else contextlib.nullcontext():
            with autocast_for(cfg, device):
                out = model(x, impl=impl, dropout=dropout, **({} if hw is None else {"hw": hw}))
            loss = cross_entropy(out["logits"], labels, ignore)
            metrics: Dict[str, object] = {"loss_main": loss.detach()}
            if "dsn" in out:
                aux = dsn_cross_entropy(out["dsn"], labels, ignore, impl)
                loss = loss + aux_weight * aux
                metrics["loss_aux"] = aux.detach()
            if cfg.model.use_wtloss and out["w_arr"]:
                wl = (instance_whitening_loss(out["w_arr"], wt_masks, 0.0, wt_nrc)
                      / len(out["w_arr"]))
                loss = loss + cfg.model.wt_reg_weight * wl
                metrics["loss_wt"] = wl.detach()
        state.optimizer.zero_grad(set_to_none=True)
        with span("train.backward"):
            loss.backward()
        replica = current_mesh().replica
        all_reduce_grads(model.parameters(), replica)
        metrics["loss"] = loss.detach()
        if replica.size > 1:
            # each rank's losses are its sums over the global denominators
            names = [k for k in ("loss", "loss_main", "loss_aux", "loss_wt") if k in metrics]
            summed = all_reduce_sum(torch.stack([metrics[k] for k in names]), replica)
            metrics.update(zip(names, summed.unbind()))
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        metrics.update(gate_oc=False, gate_np=False, gate_dec=False)
        return metrics


@torch.no_grad()
def covstat_pass(model, cov_layers: List, view_pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                 cfg: Config, device: torch.device
                 ) -> Tuple[List[torch.Tensor], List[float]]:
    """The ISW statistics phase: each pair's two NHWC batches, concatenated,
    through the eval-mode model with ``cal_covstat`` (under the step's
    autocast), each map's variance of covariance into its layer
    (``covstat_update``), then the masks frozen. Returns ``(wt_masks,
    wt_nrc)`` for ``zoo_train_step``: fp32 masks on ``device`` and the
    counts of removed entries, rank 0's on every rank (two broadcasts).
    With a spatial axis (``core/mesh.py``) each rank runs its band of
    every view's rows, in one band scope with the update."""
    was_training = model.training
    model.eval()
    mesh = current_mesh()
    try:
        for a, b in view_pairs:
            x = torch.from_numpy(np.concatenate([a, b], axis=0)).to(device)
            hw = tuple(x.shape[1:3])
            x = spatial_sharding(mesh, x).permute(0, 3, 1, 2).float().contiguous()
            with bands(*hw, mesh=mesh):
                with autocast_for(cfg, device):
                    w_arr = model(x, cal_covstat=True,
                                  **({} if mesh.sp == 1 else {"hw": hw}))["w_arr"]
                covstat_update(cov_layers, w_arr)
    finally:
        model.train(was_training)
    masks, nrc = [], []
    for layer in cov_layers:
        if hasattr(layer, "set_mask_matrix"):
            layer.set_mask_matrix()
        _eye, mask, _margin, n = layer.get_mask_matrix()
        masks.append(torch.as_tensor(mask, dtype=torch.float32, device=device))
        nrc.append(float(n))
    if world() > 1 and masks:
        sizes = [m.numel() for m in masks]
        flat = broadcast(torch.cat([m.reshape(-1) for m in masks]))
        masks = [part.view_as(m) for m, part in zip(masks, flat.split(sizes))]
        nrc = broadcast(torch.tensor(nrc, dtype=torch.float64, device=device)).tolist()
    return masks, nrc
