"""Everything a run feeds the program and the reference, made from ``--seed``.

Each kind of draw has its own stream, seeded from ``(seed, role)`` through
numpy's SeedSequence, so a seed of any size gives 63-bit seeds and one role
never shifts another. Draws are made on the run's device in a few large
calls; the same seed gives the same inputs on one kind of device.

- ``weights``: a state_dict for the model's keys, from one normal draw:
  convs Kaiming-normal (fan_out in the trunk, fan_in in the heads and the
  OC buffers), norm scales 1 + 0.1 N and shifts 0.1 N, running means 0.1 N
  and variances 1 + 0.1 |N|, biases 0, the OC BN scales N(0, 0.5) as their
  re-draw makes them. The last BN of every residual branch (``bn3``) is
  damped by ``DAMP``: at plain random weights a step's gradient is chaotic
  (any rounding decorrelates it, ROADMAP C3), and near-identity blocks, as
  a trained trunk's are, keep it a function of the arithmetic's precision.
- ``label_maps``: piecewise-constant label maps, each a grid of random
  rectangles (cuts drawn per image) over the classes, a share of the cells
  ignored (255), so the confusion-matrix kernel reads runs, as of real
  labels. ``images``: uint8, each class's colour plus uniform noise.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

DAMP = 0.1
GATE_BLOCK = 8  # the 8 combinations of MRFP's three gates
ROLES = ("weights", "pool", "perturb", "dropout", "sample", "views", "order")


def role_seed(seed: int, role: str, index: int = 0) -> int:
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), ROLES.index(role), int(index)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, role: str, device, index: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(role_seed(seed, role, index))


def _std(shape, head_fan_in: bool) -> float:
    o, i, kh, kw = shape
    fan = (i if head_fan_in else o) * kh * kw
    return float(np.sqrt(2.0 / fan))


@torch.no_grad()
def weights(template: Dict[str, torch.Tensor], seed: int, device) -> Dict[str, torch.Tensor]:
    """A state_dict with ``template``'s keys and shapes (any device, meta
    too), made on ``device`` from ``seed``."""
    floats = {k: v for k, v in template.items() if v.is_floating_point()}
    total = sum(v.numel() for v in floats.values())
    flat = torch.randn(total, generator=generator(seed, "weights", device), device=device)
    out, offset = {}, 0
    for key, v in template.items():
        if not v.is_floating_point():
            out[key] = torch.zeros(v.shape, dtype=v.dtype, device=device)
            continue
        x = flat[offset:offset + v.numel()].view(v.shape)
        offset += v.numel()
        leaf = key.rsplit(".", 1)[-1]
        oc = key.startswith("OC")
        if v.dim() == 4:
            out[key] = x * _std(v.shape, head_fan_in=oc or not key.startswith("layer"))
        elif leaf == "bias" and (oc or _is_conv_bias(key, template)):
            out[key] = torch.zeros_like(x)
        elif oc:  # an OC BatchNorm's scale (its shift is a bias above)
            out[key] = 0.5 * x
        elif leaf == "weight":
            out[key] = (1.0 + 0.1 * x) * (DAMP if key.endswith("bn3.weight") else 1.0)
        elif leaf == "running_var":
            out[key] = 1.0 + 0.1 * x.abs()
        else:  # a norm's bias, a running mean
            out[key] = 0.1 * x
    return out


def _is_conv_bias(key: str, template) -> bool:
    return template.get(key[:-len("bias")] + "weight", torch.empty(0)).dim() == 4


@torch.no_grad()
def label_maps(n: int, h: int, w: int, classes: int, ignore_share: float, cell: int,
               gen: torch.Generator, device) -> torch.Tensor:
    """(n, h, w) uint8 label maps of random rectangles."""
    kr, kc = max(1, h // cell), max(1, w // cell)
    rows = _regions(n, h, kr, gen, device)
    cols = _regions(n, w, kc, gen, device)
    grid = torch.randint(0, classes, (n, kr + 1, kc + 1), generator=gen, device=device)
    ignored = torch.rand((n, kr + 1, kc + 1), generator=gen, device=device) < ignore_share
    grid = torch.where(ignored, 255, grid).to(torch.uint8)
    b = torch.arange(n, device=device)[:, None, None]
    return grid[b, rows[:, :, None], cols[:, None, :]]


def _regions(n: int, size: int, cuts: int, gen, device) -> torch.Tensor:
    """(n, size) region index of each position, for ``cuts`` sorted cuts."""
    pos = torch.sort(torch.randint(1, size, (n, cuts), generator=gen, device=device), 1).values
    at = torch.arange(size, device=device).expand(n, size).contiguous()
    return torch.searchsorted(pos, at, right=True)


@torch.no_grad()
def images_for(labels: torch.Tensor, gen: torch.Generator, noise: int = 40) -> torch.Tensor:
    """(n, h, w, 3) uint8: a random colour a class (one more for 255)
    plus uniform noise of +-``noise``."""
    device = labels.device
    palette = torch.randint(0, 256, (257, 3), generator=gen, device=device, dtype=torch.int16)
    base = palette[labels.long()]
    jitter = torch.randint(-noise, noise + 1, base.shape, generator=gen, device=device,
                           dtype=torch.int16)
    return (base + jitter).clamp_(0, 255).to(torch.uint8)


def pool(n: int, hw: Tuple[int, int], classes: int, traffic: dict, seed: int, device,
         pinned: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` images (n, h, w, 3) and labels (n, h, w), uint8, on the host
    (pinned where ``pinned``), made on ``device`` in chunks of 8."""
    h, w = hw
    img = torch.empty((n, h, w, 3), dtype=torch.uint8, pin_memory=pinned)
    lbl = torch.empty((n, h, w), dtype=torch.uint8, pin_memory=pinned)
    gen = generator(seed, "pool", device)
    for k in range(0, n, 8):
        m = min(8, n - k)
        labels = label_maps(m, h, w, classes, traffic["ignore_share"], traffic["label_cell"],
                            gen, device)
        img[k:k + m].copy_(images_for(labels, gen))
        lbl[k:k + m].copy_(labels)
    return img, lbl


def np_plus_draws(batch: int, channels: Tuple[int, ...], std: float, seed: int, index: int,
                  device):
    """NP+'s (alpha, noise) for each site, (batch, C, 1, 1) fp32:
    alpha ~ N(1, std), noise ~ N(0, std) (deepv3.py:274-275)."""
    gen = generator(seed, "perturb", device, index)
    out = []
    for c in channels:
        alpha = 1.0 + std * torch.randn((batch, c, 1, 1), generator=gen, device=device)
        noise = std * torch.randn((batch, c, 1, 1), generator=gen, device=device)
        out.append((alpha, noise))
    return out


def keep_mask(shape, rate: float, seed: int, index: int, device) -> torch.Tensor:
    """A dropout keep mask (True: kept) of ``shape``."""
    u = torch.rand(shape, generator=generator(seed, "dropout", device, index), device=device)
    return u < 1.0 - rate


def balanced_gates(steps: int, seed: int, block: int = GATE_BLOCK):
    """Gate triples (oc, np, dec) for ``steps`` steps: every block of 8
    holds each of the 8 combinations once, in an order drawn from the seed,
    so each gate fires in half the steps (p = 0.5) and every seed's window
    holds the same mix."""
    rng = np.random.default_rng(role_seed(seed, "order"))
    combos = [(bool(i & 1), bool(i & 2), bool(i & 4)) for i in range(block)]
    out = []
    while len(out) < steps:
        out.extend(combos[i] for i in rng.permutation(block))
    return out[:steps]


def view_pairs(cfg: dict, images: torch.Tensor, seed: int):
    """The statistics pass's pairs: ``covstat_batches`` batches of the
    pool's first images, fp32 NHWC, and a second view of each by a
    per-image brightness and contrast jitter and pixel noise (the role of
    RobustNet's two colour-jittered views), made from the seed."""
    b, k = cfg["train"]["batch_size"], cfg["model"]["covstat_batches"]
    rng = np.random.default_rng(role_seed(seed, "views"))
    pairs = []
    for i in range(k):
        a = images[i * b:(i + 1) * b].numpy().astype(np.float32)
        gain = rng.uniform(0.8, 1.2, (b, 1, 1, 1)).astype(np.float32)
        shift = rng.uniform(-20.0, 20.0, (b, 1, 1, 1)).astype(np.float32)
        noise = rng.normal(0.0, 4.0, a.shape).astype(np.float32)
        pairs.append((a, np.clip(a * gain + shift + noise, 0.0, 255.0).astype(np.float32)))
    return pairs
