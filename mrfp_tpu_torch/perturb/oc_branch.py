"""The OC (overcomplete / HRFP) branch — a frozen random encoder-decoder, NCHW.

A port of mrfp_tpu/perturb/oc_branch.py (reference deepv3.py:221-254
construction, :290-306 re-randomisation, :320-327 forward). Eight 3x3 convs
whose weights are never trained; when the stem gate fires they are re-drawn
(Kaiming-normal convs, BN weight ~ N(0, 0.5), network/mynn.py:57-74). The
encoder upsamples the stem features above input resolution with nearest
chains (x1.205, x1.2, x1.2, then H/2); the decoder brings them back to
(ceil(H/4), ceil(W/4)). The encoder's H/2 output also feeds the MRFP+
decoder injection (deepv3.py:355-357).

Per stage the order is conv -> nearest resize -> BN -> ReLU, as the
reference writes it: the BN moments are taken on the resized map (nearest
duplication reweights them, so the order matters). The BNs run in train
mode with no running buffers: batch statistics, biased variance, eps 1e-5,
in fp32, cast back to the compute dtype. With more than one process the
statistics are the global batch's. On the card the chain after each conv
is one fused kernel pair (``ops/oc_stage.py``), and the maps stay
channels-last between the convs: the stem features enter enc1's conv as a
channels-last bf16 copy (``to_channels_last``), dec4 writes NCHW for the
add onto the stem features, and enc4 writes what its readers take
(channels-last for dec1's conv, NCHW for the decoder injection, or both);
the convs there take no bias, which each stage's BN cancels. On the CPU
each stage is the reference's composition (``oc_stage_plain``), NCHW.

The tensors are buffers of the model under the reference's names
(``OClayer1..4``, ``OCdeclayer1..4`` with ``weight``/``bias``;
``OC1_bn..OC4_bn``, ``OC1_decbn..OC4_decbn`` with ``weight``/``bias``), so
checkpoints carry them and the optimizer never sees them; the input of the
branch still gets its gradient.

Under spatial parallelism every stage works on this rank's band of rows:
the convs fetch their halo rows (``nn.layers.conv2d_rows``), the nearest
resizes run on the band tables of the global chain (``ops/resize.py``),
the BN moments stay world-global, and every size comes from the global
``(h, w)``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from mrfp_tpu_torch.nn.layers import conv2d_rows
from mrfp_tpu_torch.ops.cuda_oc_stage import NCHW, NHWC
from mrfp_tpu_torch.ops.oc_stage import oc_stage, to_channels_last
from mrfp_tpu_torch.ops.resize import _use_kernel
from mrfp_tpu_torch.utils.profiling import span

# (name, in_ch, out_ch, dilation); padding == dilation keeps the spatial size
_LAYERS: Tuple[Tuple[str, int, int, int], ...] = (
    ("enc1", 64, 64, 1),
    ("enc2", 64, 64, 1),
    ("enc3", 64, 128, 2),
    ("enc4", 128, 256, 2),
    ("dec1", 256, 128, 1),
    ("dec2", 128, 64, 1),
    ("dec3", 64, 64, 2),
    ("dec4", 64, 64, 2),
)

# stage -> (conv module, BN module) in the reference's state_dict
REF_NAMES = {
    "enc1": ("OClayer1", "OC1_bn"), "enc2": ("OClayer2", "OC2_bn"),
    "enc3": ("OClayer3", "OC3_bn"), "enc4": ("OClayer4", "OC4_bn"),
    "dec1": ("OCdeclayer1", "OC1_decbn"), "dec2": ("OCdeclayer2", "OC2_decbn"),
    "dec3": ("OCdeclayer3", "OC3_decbn"), "dec4": ("OCdeclayer4", "OC4_decbn"),
}

# stage -> (conv weight, conv bias, BN weight, BN bias)
OCParams = Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]


class FrozenTensors(nn.Module):
    """Named buffers: saved in the state_dict, moved with the model, never
    handed to an optimizer."""

    def __init__(self, **shapes):
        super().__init__()
        for name, shape in shapes.items():
            self.register_buffer(name, torch.zeros(shape))


def add_oc_buffers(model: nn.Module) -> None:
    """Give ``model`` the 16 OC modules as top-level children (zeros until
    ``oc_maybe_resample`` or a state_dict fills them)."""
    for name, cin, cout, _d in _LAYERS:
        conv, bn = REF_NAMES[name]
        model.add_module(conv, FrozenTensors(weight=(cout, cin, 3, 3), bias=(cout,)))
        model.add_module(bn, FrozenTensors(weight=(cout,), bias=(cout,)))


def oc_params(model: nn.Module) -> OCParams:
    """The OC buffers of ``model``, per stage."""
    out = {}
    for name, *_ in _LAYERS:
        conv, bn = (getattr(model, n) for n in REF_NAMES[name])
        out[name] = (conv.weight, conv.bias, bn.weight, bn.bias)
    return out


def oc_init(generator: torch.Generator, bn_std: float = 0.5) -> Dict[str, torch.Tensor]:
    """A fresh OC state under the reference's names, drawn on the CPU:
    conv weight ~ Kaiming normal, fan_in, relu gain (std sqrt(2 / (cin*9))),
    conv bias 0, BN weight ~ N(0, bn_std), BN bias 0."""
    sd = {}
    for name, cin, cout, _d in _LAYERS:
        conv, bn = REF_NAMES[name]
        std = math.sqrt(2.0 / (cin * 9))
        sd[f"{conv}.weight"] = std * torch.randn((cout, cin, 3, 3), generator=generator)
        sd[f"{conv}.bias"] = torch.zeros(cout)
        sd[f"{bn}.weight"] = bn_std * torch.randn((cout,), generator=generator)
        sd[f"{bn}.bias"] = torch.zeros(cout)
    return sd


@torch.no_grad()
def oc_maybe_resample(model: nn.Module, gate: bool, generator: torch.Generator,
                      bn_std: float = 0.5) -> None:
    """Re-draw all 16 OC modules of ``model`` in place when ``gate`` is set
    (deepv3.py:290-306). The draws (3.5 MB) cross from pinned memory
    without a sync; the ``oc.redraw`` span counts their ``bytes`` and the
    bytes ``pinned`` for the copy."""
    if not gate:
        return
    with span("oc.redraw") as s:
        moved = pinned = 0
        for key, value in oc_init(generator, bn_std).items():
            buf = model.get_buffer(key)
            moved += value.numel() * value.element_size()
            if buf.is_cuda:
                value = value.pin_memory()
                pinned += value.numel() * value.element_size()
            buf.copy_(value, non_blocking=True)
        s.add(bytes=moved, pinned=pinned)


def _stage(p, x: torch.Tensor, dilation: int, scale=None, size=None,
           impl: Optional[str] = None, layouts: Sequence = (NHWC,)) -> Tuple[torch.Tensor, ...]:
    """relu(bn(resize(conv(x)))) — the reference's per-layer pattern
    (``ops/oc_stage.py``), one output per entry of ``layouts``. On the card,
    through the kernels or their plain versions alike, the conv reads and
    writes channels-last and takes no bias: train-mode BN subtracts the
    batch mean, so a per-channel constant added before it leaves its output
    as it is (and cuDNN adds a bias to a channels-last map in a pass of its
    own). On the CPU it is the reference's conv, NCHW, with its bias."""
    weight, bias, bn_weight, bn_bias = p
    if x.device.type != "cpu":
        x = to_channels_last(x) if _use_kernel(x, impl) else x.contiguous(memory_format=NHWC)
        bias = None
    y = conv2d_rows(x, weight, bias, padding=dilation, dilation=dilation)
    return oc_stage(y, bn_weight, bn_bias, size=size, scale=scale, impl=impl, layouts=layouts)


def _dilation(name: str) -> int:
    return next(d for n, _ci, _co, d in _LAYERS if n == name)


def oc_encode(params: OCParams, xp: torch.Tensor, hw: Tuple[int, int],
              scales_enc: Tuple[float, ...] = (1.205, 1.2, 1.2),
              impl: Optional[str] = None,
              layouts: Sequence = (NHWC,)) -> Tuple[torch.Tensor, ...]:
    """Encoder half: stem features -> OCout_dec (N, 256, int(H/2), int(W/2)),
    the overcomplete bottleneck the decoder injection adds: one map per
    entry of ``layouts`` (channels-last for the decoder's first conv, NCHW
    for the injection), all from one stage."""
    h, w = hw
    x = xp
    with span("oc.encode"):
        for name, s in zip(("enc1", "enc2", "enc3"), scales_enc):
            x, = _stage(params[name], x, _dilation(name), scale=(s, s), impl=impl)
        return _stage(params["enc4"], x, _dilation("enc4"), size=(int(h / 2), int(w / 2)),
                      impl=impl, layouts=layouts)


def oc_decode(params: OCParams, oc_dec: torch.Tensor, hw: Tuple[int, int],
              scales_dec: Tuple[float, ...] = (0.838, 0.798),
              impl: Optional[str] = None) -> torch.Tensor:
    """Decoder half: OCout_dec -> OCout (N, 64, ceil(H/4), ceil(W/4)), the map
    added onto the stem features (NCHW, as they are)."""
    h, w = hw
    with span("oc.decode"):
        x, = _stage(params["dec1"], oc_dec, _dilation("dec1"), size=(int(h / 2), int(w / 2)),
                    impl=impl)
        for name, s in zip(("dec2", "dec3"), scales_dec):
            x, = _stage(params[name], x, _dilation(name), scale=(s, s), impl=impl)
        out, = _stage(params["dec4"], x, _dilation("dec4"),
                      size=(math.ceil(h / 4), math.ceil(w / 4)), impl=impl, layouts=(NCHW,))
        return out
