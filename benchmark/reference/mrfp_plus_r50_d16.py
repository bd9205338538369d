"""Plain reference of MRFP+ (CVPR 2024; deepv3.py:152-367 MRFPPlus).

DeepLabV3+ R50-D16 with ``wt_layer`` (0,0,4,4,4,0,0) (``common.py``), and
in a perturbed train forward (deepv3.py:280-367):

- NP+ (deepv3.py:268-277) after the stem and after layer1: with the
  per-sample, per-channel spatial mean ``m`` (B,C,1,1), ``d`` the std of
  ``m`` over the batch (unbiased), ``beta = 1 + noise * d / max(d) * 1.5``,
  the map becomes ``alpha f - alpha m + beta m``;
- the OC branch: eight frozen 3x3 convs, each followed by a nearest resize,
  a batch-statistics BatchNorm (biased variance, eps 1e-5, the buffers'
  affine) and a ReLU. The encoder reads the unperturbed stem map and
  resizes by x1.205, x1.2, x1.2, then to (H/2, W/2); the decoder goes to
  (H/2, W/2), by x0.838 and x0.798, then to (ceil(H/4), ceil(W/4)) and is
  added onto the stem map (gate ``oc``);
- the decoder injection (gate ``dec``): the decoder's map upsampled to
  (H/2, W/2) plus the OC encoder's output, before the classifier.

The eval forward is the plain DeepLabV3+ (the OC buffers are not needed).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from benchmark import inputs
from benchmark.reference import common

NP_SITES = (64, 256)  # NP+ after the stem and after layer1
CKPT = True

# (stage, cin, cout, dilation, conv buffers, BN buffers): the published names
OC_LAYERS = (("enc1", 64, 64, 1, "OClayer1", "OC1_bn"),
             ("enc2", 64, 64, 1, "OClayer2", "OC2_bn"),
             ("enc3", 64, 128, 2, "OClayer3", "OC3_bn"),
             ("enc4", 128, 256, 2, "OClayer4", "OC4_bn"),
             ("dec1", 256, 128, 1, "OCdeclayer1", "OC1_decbn"),
             ("dec2", 128, 64, 1, "OCdeclayer2", "OC2_decbn"),
             ("dec3", 64, 64, 2, "OCdeclayer3", "OC3_decbn"),
             ("dec4", 64, 64, 2, "OCdeclayer4", "OC4_decbn"))


@dataclasses.dataclass
class Perturb:
    """One step's gates and NP+ draws ``(alpha, noise)``, each (B, C, 1, 1)."""
    gate_oc: bool
    gate_np: bool
    gate_dec: bool
    np0: Tuple[torch.Tensor, torch.Tensor]
    np1: Tuple[torch.Tensor, torch.Tensor]


class Buffers(nn.Module):
    def __init__(self, **shapes):
        super().__init__()
        for name, shape in shapes.items():
            self.register_buffer(name, torch.zeros(shape))


class MRFPPlus(common.DeepLabV3Plus):
    def __init__(self, cfg: dict, oc_branch: bool = True):
        m = cfg["model"]
        super().__init__(m["num_classes"], m["wt_layer"], m["blocks"], m["aspp_rates"])
        p = cfg["perturb"]
        self.np_scale = p["np_scale"]
        self.scales_enc, self.scales_dec = p["oc_scales_enc"], p["oc_scales_dec"]
        self.oc_branch = oc_branch
        if oc_branch:
            for _s, cin, cout, _d, conv_name, bn_name in OC_LAYERS:
                self.add_module(conv_name, Buffers(weight=(cout, cin, 3, 3), bias=(cout,)))
                self.add_module(bn_name, Buffers(weight=(cout,), bias=(cout,)))

    def _oc_stage(self, x: torch.Tensor, i: int, scale=None, size=None) -> torch.Tensor:
        _s, _ci, _co, d, conv_name, bn_name = OC_LAYERS[i]
        cv, nb = getattr(self, conv_name), getattr(self, bn_name)
        y = common.conv_fn(x, cv.weight, cv.bias, d)
        y = common.nearest(y, scale=scale, size=size)
        y = F.batch_norm(y, None, None, nb.weight, nb.bias, training=True, eps=1e-5)
        return F.relu(y)

    def oc_encode(self, xp: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        x = xp
        for i, s in enumerate(self.scales_enc):
            x = self._oc_stage(x, i, scale=s)
        return self._oc_stage(x, 3, size=(int(hw[0] / 2), int(hw[1] / 2)))

    def oc_decode(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        x = self._oc_stage(x, 4, size=(int(hw[0] / 2), int(hw[1] / 2)))
        for i, s in zip((5, 6), self.scales_dec):
            x = self._oc_stage(x, i, scale=s)
        return self._oc_stage(x, 7, size=(math.ceil(hw[0] / 4), math.ceil(hw[1] / 4)))

    def np_plus(self, f: torch.Tensor, draws: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        alpha, noise = draws
        mean = f.mean(dim=(2, 3), keepdim=True)
        spread = mean.std(dim=0, keepdim=True)
        beta = 1.0 + noise * (spread / spread.max() * self.np_scale)
        return alpha * f - alpha * mean + beta * mean

    def forward(self, x: torch.Tensor, perturb: Optional[Perturb] = None) -> torch.Tensor:
        h, w = int(x.shape[2]), int(x.shape[3])
        xp = self.run(self.stem, x, None)
        feat, oc_dec = xp, None
        if self.training and perturb is not None:
            if perturb.gate_np:
                feat = self.np_plus(xp, perturb.np0)
            if perturb.gate_oc or perturb.gate_dec:
                oc_dec = self.run(self.oc_encode, xp, (h, w))
                if perturb.gate_oc:
                    feat = self.run(self.oc_decode, oc_dec, (h, w)) + feat
            if not perturb.gate_dec:
                oc_dec = None
        feat = self.run(self.layer1, feat)
        if self.training and perturb is not None and perturb.gate_np:
            feat = self.np_plus(feat, perturb.np1)
        low = feat
        feat = self.run(self.layer4, self.run(self.layer3, self.run(self.layer2, feat)))
        dec1 = self.run(self.decode, self.run(self.aspp, feat), low)
        if oc_dec is not None:
            dec1 = common.upsample(dec1, (int(h / 2), int(w / 2))) + oc_dec
        return common.upsample(self.final2(dec1), (h, w))


def build(cfg: dict, train: bool) -> MRFPPlus:
    """The model on the current default device; the train model carries
    the OC buffers, the eval model does not (``cli.eval``'s MRFP)."""
    return MRFPPlus(cfg, oc_branch=train).train(train)


def objective(cfg: dict, perturb_of) -> callable:
    """The train objective for ``common.sgd_steps``: the CE of the logits,
    ``perturb_of(step)`` the step's gates and draws."""
    ignore = cfg["train"]["ignore_index"]

    def fn(model, step: int, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        images, labels = batch
        loss = common.cross_entropy(model(images, perturb_of(step)), labels, ignore)
        return loss, {"loss": loss.detach()}
    return fn


def perturb_all_on(draws: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> Perturb:
    return Perturb(True, True, True, tuple(draws[0]), tuple(draws[1]))


def template(cfg: dict, train: bool):
    """The state_dict's keys and shapes, on the meta device."""
    with torch.device("meta"):
        return build(cfg, train).state_dict()


def train_readings(cfg: dict, seed: int, batches, device, rounding=None, pool=None,
                   given=None) -> dict:
    """The reference's three steps on ``batches`` (NCHW fp32 images, int64
    labels) from the seed's weights, every gate firing with the seed's NP+
    draws: each step's loss, each leaf's first gradient norm and its
    change after the last step. ``given``, the judged run's own answers
    from its set-up, holds nothing that this configuration's steps take."""
    weights = inputs.weights(template(cfg, True), seed, device)
    with torch.device(device):
        model = build(cfg, True)
    model.load_state_dict(weights, strict=True)
    del weights
    model.checkpointing = CKPT
    n, std = batches[0][0].shape[0], cfg["perturb"]["np_std"]

    def perturb_of(step):
        return perturb_all_on(inputs.np_plus_draws(n, NP_SITES, std, seed, step, device))

    t = cfg["train"]
    with common.exact_fp32(), common.rounded(rounding):
        parts, grads, change = common.sgd_steps(
            model, batches, objective(cfg, perturb_of), t["lr"], t["momentum"],
            t["weight_decay"], t["max_iter"], t["poly_power"])
    return {"parts": parts, "grad": grads, "change": change}


@torch.no_grad()
def eval_logits(cfg: dict, seed: int, images, device, rounding=None):
    """A generator of each NCHW fp32 image's (1, C, H, W) logits."""
    weights = inputs.weights(template(cfg, False), seed, device)
    with torch.device(device):
        model = build(cfg, False)
    model.load_state_dict(weights, strict=True)
    with common.exact_fp32(), common.rounded(rounding):
        for x in images:
            yield model(x)


def train_work(cfg: dict, gates) -> tuple:
    """(FLOPs, resizes) of one train step with ``gates`` (oc, np, dec)."""
    t = cfg["train"]
    n, s = t["batch_size"], t["crop_size"]
    with torch.device("meta"):
        model = build(cfg, True)
        draws = [(torch.empty(n, c, 1, 1), torch.empty(n, c, 1, 1)) for c in NP_SITES]
        perturb = Perturb(*gates, *draws)
        batch = (torch.empty(n, 3, s, s), torch.zeros(n, s, s, dtype=torch.long))
        return common.count_work(model, objective(cfg, lambda step: perturb), batch)


def eval_work(cfg: dict, hw) -> tuple:
    """(FLOPs, resizes) of one eval forward of a (1, 3, H, W) image."""
    with torch.device("meta"):
        return common.count_work(build(cfg, False), None, torch.empty(1, 3, *hw))
