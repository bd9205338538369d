"""The system under test for the zoo's configurations: ``mrfp_tpu_torch``'s
``DeepV3Plus``, its statistics pass (``covstat_pass``) and its step
(``zoo_train_step``), with the port's SGD state (``create_train_state``).

The benchmark hands them its seed-made weights (``strict=True``), batches,
the statistics pass's view pairs and, for the steps that the reference
follows, the DSN head's dropout keep mask.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark import inputs


def port_config(cfg: dict, seed: int):
    from mrfp_tpu_torch.core.config import Config, DataConfig, ModelConfig, PerturbConfig, \
        TrainConfig
    m, t = cfg["model"], cfg["train"]
    return Config(
        model=ModelConfig(num_classes=m["num_classes"], trunk=m["trunk"], variant=m["variant"],
                          wt_layer=tuple(m["wt_layer"]), use_wtloss=m["use_wtloss"],
                          use_dsn_aux=True, relax_denom=m["relax_denom"],
                          clusters=m["clusters"], wt_reg_weight=m["wt_reg_weight"],
                          hrfp_plus=False),
        perturb=PerturbConfig(enabled=False),
        data=DataConfig(batch_size=t["batch_size"], crop_size=t["crop_size"],
                        ignore_index=t["ignore_index"]),
        train=TrainConfig(lr=t["lr"], momentum=t["momentum"], weight_decay=t["weight_decay"],
                          max_iter=t["max_iter"], poly_power=t["poly_power"], seed=int(seed),
                          compute_dtype=t["compute_dtype"]))


def _model(cfg: dict):
    from mrfp_tpu_torch.models.deepv3_zoo import DeepV3Plus
    m = cfg["model"]
    return DeepV3Plus(num_classes=m["num_classes"], trunk=m["trunk"], variant=m["variant"],
                      wt_layer=tuple(m["wt_layer"]), use_dsn=True)


def build_train(cfg: dict, weights: Dict[str, torch.Tensor], seed: int, device):
    from mrfp_tpu_torch.train.state import create_train_state
    pcfg = port_config(cfg, seed)
    with torch.device(device):
        model = _model(cfg)
    model.load_state_dict(weights, strict=True)
    return create_train_state(model, pcfg.train), pcfg


def prepare(state, pcfg, cfg: dict, pairs, device):
    """The statistics pass of ``cli.train_zoo``: its masks and their counts,
    and the DSN weight, for ``step``; and, for the comparison, each map's
    variances of covariance as the pass hands them to its k-means (read
    where each covariance layer freezes its mask)."""
    from mrfp_tpu_torch.models.deepv3_zoo import build_cov_layers
    from mrfp_tpu_torch.train.zoo_step import covstat_pass
    m = pcfg.model
    layers = build_cov_layers(m.trunk, m.wt_layer, m.relax_denom, m.clusters)
    variances = []
    for layer in layers:
        layer.set_mask_matrix = _recording(layer, variances)
    masks, counts = covstat_pass(state.model, layers, pairs, pcfg, torch.device(device))
    return {"masks": masks, "counts": counts, "variances": variances,
            "aux_weight": cfg["model"]["aux_weight"]}


def _recording(layer, into: list):
    """``layer.set_mask_matrix`` that first keeps the mean variance it
    clusters (``var_matrix / count_var_cov``, as the layer computes it)."""
    set_mask = layer.set_mask_matrix

    def set_mask_matrix():
        into.append(layer.var_matrix / layer.count_var_cov)
        set_mask()
    return set_mask_matrix


def keep_shape(cfg: dict):
    t = cfg["train"]
    side = t["crop_size"] // cfg["model"]["output_stride"]
    return (t["batch_size"], cfg["model"]["dsn_dim"], side, side)


def step(state, images, labels, pcfg, extra, dropout=None) -> Dict[str, object]:
    from mrfp_tpu_torch.train.zoo_step import zoo_train_step
    return zoo_train_step(state, images, labels, pcfg, extra["masks"], extra["counts"],
                          aux_weight=extra["aux_weight"], dropout=dropout)


class Trainer:
    """The zoo step as a cell drives it, after the statistics pass.
    ``checked`` runs a step that the reference follows, with the DSN
    dropout's keep mask from the benchmark (``inputs.keep_mask``);
    ``window`` a measured step, its mask from the port's own stream. The
    zoo has no gates: every step is the same work."""

    block = 1

    def __init__(self, cfg: dict, weights, seed: int, device, pool):
        self.cfg, self.seed, self.device = cfg, seed, device
        self.state, self.pcfg = build_train(cfg, weights, seed, device)
        self.pairs = inputs.view_pairs(cfg, pool[0], seed)
        self.extra = prepare(self.state, self.pcfg, cfg, self.pairs, device)

    def checked(self, images, labels, index: int):
        keep = inputs.keep_mask(keep_shape(self.cfg), self.cfg["model"]["dsn_dropout"],
                                self.seed, index, self.device)
        return step(self.state, images, labels, self.pcfg, self.extra, keep)

    def window(self, images, labels, index: int, gates):
        return step(self.state, images, labels, self.pcfg, self.extra)

    def gates(self, k: int):
        return (False, False, False)

    def readings(self) -> Dict[str, object]:
        """The statistics pass's answers, on the host: its masks and
        counts, which the reference's steps follow, and the variances they
        were clustered from."""
        return {"masks": [mk.cpu().numpy() for mk in self.extra["masks"]],
                "counts": [float(c) for c in self.extra["counts"]],
                "variances": [np.asarray(v) for v in self.extra["variances"]]}
