"""Train state and optimizer (mrfp_tpu/train/state.py:32-52).

SGD as main.py:826,832-839: lr 1e-2, momentum 0.9, weight decay 5e-4
coupled (added to the gradient before the momentum, as
``optax.add_decayed_weights`` does), on every trainable parameter with no
mask; poly decay ``(1 - min(step, max_iter)/max_iter) ** 0.9`` through
``LambdaLR``. The OC buffers are model state, never optimizer targets
(requires_grad_(False) in the reference, deepv3.py:221-237).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from mrfp_tpu_torch.core.config import TrainConfig


@dataclasses.dataclass
class TrainState:
    """What a checkpoint holds: the step, the model (parameters, BN running
    statistics, OC buffers), the optimizer, the schedule and the run seed."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    seed: int


def poly_factor(step: int, max_iter: int, power: float) -> float:
    return (1.0 - min(step, max_iter) / max_iter) ** power


def make_optimizer(model: nn.Module, cfg: TrainConfig):
    """(SGD, LambdaLR) for ``model``'s trainable parameters."""
    if cfg.momentum_dtype is not None:
        raise NotImplementedError(
            f"momentum_dtype={cfg.momentum_dtype!r} is not ported: the momentum "
            f"buffer stays fp32 (see ROADMAP item A5, deferred)")
    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                          weight_decay=cfg.weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda s: poly_factor(s, cfg.max_iter, cfg.poly_power))
    return opt, sched


def create_train_state(model: nn.Module, cfg: TrainConfig) -> TrainState:
    """A fresh state at step 0 around ``model`` (already on its device)."""
    opt, sched = make_optimizer(model, cfg)
    return TrainState(step=0, model=model, optimizer=opt, scheduler=sched,
                      seed=cfg.seed)
