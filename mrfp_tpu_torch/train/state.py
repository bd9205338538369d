"""Train state and optimizer (mrfp_tpu/train/state.py:32-52).

SGD as main.py:826,832-839: lr 1e-2, momentum 0.9, weight decay 5e-4
coupled (added to the gradient before the momentum, as
``optax.add_decayed_weights`` does), on every trainable parameter with no
mask; poly decay ``(1 - min(step, max_iter)/max_iter) ** 0.9`` through
``LambdaLR``. The OC buffers are model state, never optimizer targets
(requires_grad_(False) in the reference, deepv3.py:221-237).

``momentum_dtype="bfloat16"`` keeps the momentum in bf16
(mrfp_tpu/train/state.py:39-52), which torch's SGD cannot: it keeps the
buffer in the parameter's dtype. ``SGDBf16Momentum`` is the update rule
of the JAX optimizer, ``optax.chain(add_decayed_weights, trace(
accumulator_dtype=bf16), scale_by_learning_rate)``, op for op.
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


class SGDBf16Momentum(torch.optim.Optimizer):
    """SGD with coupled weight decay and a bf16 momentum trace, as optax
    computes it for fp32 parameters ``p`` and gradients ``g``:

      u = g + wd * p                  (fp32; ``add_decayed_weights``)
      f = u + bf16(momentum) * t      (the product in bf16: optax multiplies
                                       the weak-typed Python decay by the bf16
                                       trace, so the decay is rounded to bf16,
                                       0.9 -> 0.8984375; the sum in fp32)
      t = bf16(f)                     (only the stored trace is rounded)
      p = p + (-lr) * f               (``scale_by_learning_rate``)

    The trace starts at zero, so the first step stores bf16(u). It is kept
    under ``momentum_buffer``, as torch's SGD names its own, and stays bf16
    through ``load_state_dict``."""

    def __init__(self, params, lr: float, momentum: float, weight_decay: float):
        super().__init__(params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("SGDBf16Momentum.step takes no closure")
        for group in self.param_groups:
            decay = float(torch.tensor(group["momentum"], dtype=torch.bfloat16))
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                trace = state.get("momentum_buffer")
                if trace is None:
                    trace = state["momentum_buffer"] = torch.zeros_like(
                        p, dtype=torch.bfloat16, memory_format=torch.preserve_format)
                f = p.grad + group["weight_decay"] * p
                f = f + trace * decay
                trace.copy_(f)
                p.add_(f * -group["lr"])
        return None

    def load_state_dict(self, state_dict) -> None:
        # torch casts a loaded floating state to its parameter's dtype
        super().load_state_dict(state_dict)
        for state in self.state.values():
            if "momentum_buffer" in state:
                state["momentum_buffer"] = state["momentum_buffer"].to(torch.bfloat16)


def make_optimizer(model: nn.Module, cfg: TrainConfig):
    """(SGD, LambdaLR) for ``model``'s trainable parameters: torch's SGD,
    or ``SGDBf16Momentum`` for ``momentum_dtype="bfloat16"``."""
    params = [p for p in model.parameters() if p.requires_grad]
    if cfg.momentum_dtype == "bfloat16":
        opt = SGDBf16Momentum(params, lr=cfg.lr, momentum=cfg.momentum,
                              weight_decay=cfg.weight_decay)
    elif cfg.momentum_dtype is None:
        opt = torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                              weight_decay=cfg.weight_decay)
    else:
        raise ValueError(f"momentum_dtype must be None or 'bfloat16', got "
                         f"{cfg.momentum_dtype!r}")
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda s: poly_factor(s, cfg.max_iter, cfg.poly_power))
    return opt, sched


def create_train_state(model: nn.Module, cfg: TrainConfig) -> TrainState:
    """A fresh state at step 0 around ``model`` (already on its device)."""
    opt, sched = make_optimizer(model, cfg)
    return TrainState(step=0, model=model, optimizer=opt, scheduler=sched,
                      seed=cfg.seed)
