"""The system under test for MRFP configurations: ``mrfp_tpu_torch``'s MRFP
model, its train state and step, and its evaluator's model.

Everything here is the port's own entry points; the benchmark hands them
its seed-made weights (``strict=True``), batches and, where the comparison
needs both sides to see the same draws, the gates and NP+ draws through
``train_step``'s ``perturb=``.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark import inputs

NP_SITES = (64, 256)  # NP+ after the stem and after layer1


def port_config(cfg: dict, seed: int):
    from mrfp_tpu_torch.core.config import Config, DataConfig, ModelConfig, PerturbConfig, \
        TrainConfig
    m, p, t = cfg["model"], cfg["perturb"], cfg["train"]
    return Config(
        model=ModelConfig(num_classes=m["num_classes"], trunk=m["trunk"], variant=m["variant"],
                          wt_layer=tuple(m["wt_layer"]), hrfp_plus=m["hrfp_plus"],
                          use_dsn_aux=False),
        perturb=PerturbConfig(enabled=True, p_oc=p["p_oc"], p_np=p["p_np"], p_dec=p["p_dec"],
                              np_std=p["np_std"], np_scale=p["np_scale"],
                              oc_bn_std=p["oc_bn_std"],
                              oc_scales_enc=tuple(p["oc_scales_enc"]),
                              oc_scales_dec=tuple(p["oc_scales_dec"])),
        data=DataConfig(batch_size=t["batch_size"], crop_size=t["crop_size"],
                        ignore_index=t["ignore_index"]),
        train=TrainConfig(lr=t["lr"], momentum=t["momentum"], weight_decay=t["weight_decay"],
                          max_iter=t["max_iter"], poly_power=t["poly_power"], seed=int(seed),
                          compute_dtype=t["compute_dtype"]))


def _model(cfg: dict, train: bool):
    from mrfp_tpu_torch.models.mrfp import MRFP
    m, p = cfg["model"], cfg["perturb"]
    return MRFP(num_classes=m["num_classes"], trunk=m["trunk"], variant=m["variant"],
                wt_layer=tuple(m["wt_layer"]), oc_branch=train, hrfp_plus=m["hrfp_plus"],
                np_std=p["np_std"], np_scale=p["np_scale"],
                oc_scales_enc=tuple(p["oc_scales_enc"]),
                oc_scales_dec=tuple(p["oc_scales_dec"]))


def build_train(cfg: dict, weights: Dict[str, torch.Tensor], seed: int, device):
    """(train state, port config) around the seed-made weights."""
    from mrfp_tpu_torch.train.state import create_train_state
    pcfg = port_config(cfg, seed)
    with torch.device(device):
        model = _model(cfg, train=True)
    model.load_state_dict(weights, strict=True)
    return create_train_state(model, pcfg.train), pcfg


def build_eval(cfg: dict, weights: Dict[str, torch.Tensor], device):
    with torch.device(device):
        model = _model(cfg, train=False)
    model.load_state_dict(weights, strict=True)
    return model.eval()


def injected(gates, draws):
    """``train_step``'s ``perturb=`` for given gates and NP+ draws (device
    tensors, or CPU generators that the port draws from)."""
    from mrfp_tpu_torch.models.mrfp import PerturbArgs
    return PerturbArgs(gate_oc=gates[0], gate_np=gates[1], gate_dec=gates[2],
                       np0=draws[0], np1=draws[1])


def step(state, images, labels, pcfg, perturb=None) -> Dict[str, object]:
    from mrfp_tpu_torch.train.step import train_step
    return train_step(state, images, labels, pcfg, perturb=perturb)


def drawn_perturb(state, pcfg, gates, seed: int, index: int):
    """A window step's perturbation with the benchmark's gates: the OC
    buffers re-drawn through the port's ``oc_maybe_resample`` when the stem
    gate fires, and NP+ drawn by the port from CPU generators, the work
    ``draw_perturb`` does with gates of its own stream."""
    from mrfp_tpu_torch.perturb.oc_branch import oc_maybe_resample
    gens = [torch.Generator().manual_seed(inputs.role_seed(seed, "perturb", 3 * index + k))
            for k in range(3)]
    oc_maybe_resample(state.model, gates[0], gens[0], pcfg.perturb.oc_bn_std)
    return injected(gates, gens[1:])


class Trainer:
    """The MRFP+ train step as a cell drives it. ``checked`` runs a step
    that the reference follows: every gate fires and NP+'s draws come from
    the benchmark (``inputs.np_plus_draws``), the OC buffers as the weights
    made them. ``window`` runs a measured step with the gates of
    ``gates(k)``: a balanced schedule in blocks of ``block`` steps, each
    block every combination of the three gates once (``inputs.balanced_gates``),
    so a window that ends on a whole block holds each equally often."""

    block = inputs.GATE_BLOCK
    schedule_steps = 100_000

    def __init__(self, cfg: dict, weights, seed: int, device, pool):
        self.cfg, self.seed, self.device = cfg, seed, device
        self.state, self.pcfg = build_train(cfg, weights, seed, device)
        self.schedule = inputs.balanced_gates(self.schedule_steps, seed)

    def gates(self, k: int):
        return self.schedule[k % self.schedule_steps]

    def readings(self) -> Dict[str, object]:
        """The set-up's answers besides the steps' (none here)."""
        return {}

    def checked(self, images, labels, index: int):
        draws = inputs.np_plus_draws(images.shape[0], NP_SITES, self.cfg["perturb"]["np_std"],
                                     self.seed, index, self.device)
        return step(self.state, images, labels, self.pcfg, injected((True,) * 3, draws))

    def window(self, images, labels, index: int, gates):
        return step(self.state, images, labels, self.pcfg,
                    drawn_perturb(self.state, self.pcfg, gates, self.seed, index))
