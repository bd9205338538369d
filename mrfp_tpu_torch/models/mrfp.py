"""MRFP / MRFP+ / plain DeepLabV3+ — the paper's model family, NCHW.

A port of mrfp_tpu/models/mrfp.py (reference deepv3.py:152-367 MRFPPlus
and :370-489 simpleDeepV3Plus). In eval mode, or in train mode without
perturbation, the graph is the plain DeepLabV3+ forward. In train mode with
``PerturbArgs`` it is the MRFP+ forward (deepv3.py:280-367):

- NP+ after the stem reads the unperturbed stem features (gate ``np``);
- the frozen OC branch reads them too, and its decoder half is added onto
  the stem features (gate ``oc``);
- NP+ after layer1 (gate ``np``);
- the decoder injection: dec1 is upsampled to (H/2, W/2) and the OC
  encoder's output added before the classifier (gate ``dec``, MRFP+ only).
  This is the reference's shape; the JAX package's commuted form (classify
  first) was a TPU memory measure, and the two agree in fp32 to ~1e-6.

The gates are Python bools drawn on the host, so a plain ``if`` skips the
OC halves a step does not use, as ``lax.cond`` does in the JAX package,
without a device sync.

Any of the nine ResNet trunks (``nn/resnet.py``) may carry the model: the
heads take the trunk's widths (ASPP reads layer4's channels, the decoder's
``bot_fine`` layer1's, the DSN head layer3's), as the JAX package's flax
modules infer them. The OC branch reads 64-channel stem features, so a
model with OC buffers refuses resnet-101, whose deep stem ends at 128
channels: the JAX package cannot trace a perturbed forward on it either
(ROADMAP C8). The zoo's other trunks raise the JAX package's ValueError
here: ``models/deepv3_zoo.py`` builds them.

With ``use_dsn`` the auxiliary DSN head reads layer3's output; the
train-mode forward then returns its fp32 logits beside the main logits
(mrfp_tpu/models/mrfp.py:175,218-219), and the eval forward, which never
needs them, returns the main logits alone.

Module names follow the reference's state_dict (``layer0.0``,
``layer1.0.conv1``, ``aspp.features.0.0``, ``aspp.img_conv.0``,
``bot_fine.0``, ``final1.0``, ``final2.0``; with ``use_dsn`` also ``dsn.0``,
``dsn.1``, ``dsn.4``; with ``oc_branch=True`` also the OC buffers
``OClayer1``..``OC4_decbn``), so the paper's ``.pth`` loads with
``load_state_dict(strict=True)`` (``mrfp_tpu_torch.weights``).

Under spatial parallelism (``core/mesh.py``) ``forward`` takes this rank's
band of the image's rows and the image's global ``hw``, and returns its
band of the logits: every module on the path computes its band of rows
(``nn/layers.py``, ``nn/norms.py``, ``nn/deeplab.py``, ``ops/resize.py``,
``perturb/``), and every size the forward names (``int(h / 2)``,
``ceil(h / 4)``, the logits') comes from the global ``hw``.

Under tensor parallelism (``core/mesh.py``, ``mp > 1``) the model is cut
by ``weights.shard_model`` and ``forward`` runs in a channel scope
(``core/mesh.py::channels``): every map of the trunk and the heads is
this rank's slice of its channels, each conv computing its slice from the
whole input map (``nn/layers.py::conv_input``). The frozen OC branch is
replicated: it reads the gathered stem map, and its outputs enter the
sliced maps through ``Channels.own`` (whose backward gathers the ranks'
cotangents). The classifier reads the gathered decoder map, so the logits
are whole on every rank of a model group.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Optional, Tuple, Union

import torch
from torch import nn

from mrfp_tpu_torch.core.mesh import active_channels, bands, channels
from mrfp_tpu_torch.nn.deeplab import ASPP, DSNHead, DeepLabDecoder
from mrfp_tpu_torch.nn.layers import conv2d, init_random_
from mrfp_tpu_torch.nn.resnet import build_trunk, variant_output_stride
from mrfp_tpu_torch.ops.cuda_oc_stage import NCHW, NHWC
from mrfp_tpu_torch.ops.resize import resize_bilinear_align_corners
from mrfp_tpu_torch.perturb.np_plus import Draws, np_plus
from mrfp_tpu_torch.perturb.oc_branch import (add_oc_buffers, oc_decode, oc_encode,
                                              oc_params)


@dataclasses.dataclass
class PerturbArgs:
    """One step's stochastic inputs to the train forward. ``np0``/``np1``:
    a generator for the NP+ draws at the stem / after layer1, or injected
    ``(alpha, beta_noise)`` of shape (B, C, 1, 1). The OC branch reads the
    model's OC buffers."""

    gate_oc: bool
    gate_np: bool
    gate_dec: bool
    np0: Union[torch.Generator, Draws, None] = None
    np1: Union[torch.Generator, Draws, None] = None


class MRFP(DeepLabDecoder):
    """DeepLabV3+ with multi-resolution feature perturbation.

    ``forward`` takes NCHW float images and returns NCHW logits: float32 in
    eval mode (also under a bf16 autocast), the compute dtype in train mode;
    in train mode with ``use_dsn``, the pair (logits, fp32 DSN logits at
    layer3's resolution). ``oc_branch`` adds the OC buffers (needed for a
    perturbed forward); ``hrfp_plus`` allows the decoder injection. The
    model is built in eval mode.
    """

    def __init__(self, num_classes: int = 19, trunk: str = "resnet-50",
                 variant: str = "D16",
                 wt_layer: Tuple[int, ...] = (0, 0, 4, 4, 4, 0, 0),
                 oc_branch: bool = False, hrfp_plus: bool = True,
                 np_std: float = 0.75, np_scale: float = 1.5,
                 oc_scales_enc: Tuple[float, ...] = (1.205, 1.2, 1.2),
                 oc_scales_dec: Tuple[float, ...] = (0.838, 0.798),
                 use_dsn: bool = False):
        net = self.build_trunk(trunk, wt_layer, variant)
        if oc_branch and net.stem_channels != 64:
            raise ValueError(
                f"trunk {trunk!r}: the OC branch reads 64-channel stem features and this "
                f"trunk's stem gives {net.stem_channels}; the JAX package's perturbed "
                f"forward fails on it too (ROADMAP C8). Train it without perturbation "
                f"(--mode baseline) or the zoo trainer")
        super().__init__(low_ch=net.stage_channels[0])
        self.variant = variant
        self.hrfp_plus = hrfp_plus
        self.np_std, self.np_scale = np_std, np_scale
        self.oc_scales_enc, self.oc_scales_dec = oc_scales_enc, oc_scales_dec
        # the reference takes the trunk's stages as its own children
        # (deepv3.py:170-189), which puts them at the top of the state_dict
        self.layer0, self.layer1, self.layer2, self.layer3, self.layer4 = (
            net.layer0, net.layer1, net.layer2, net.layer3, net.layer4)
        self.aspp = ASPP(net.stage_channels[3], 256,
                         output_stride=variant_output_stride(variant))
        self.final2 = nn.Sequential(conv2d(256, num_classes, 1, bias=True))
        self.oc_branch = oc_branch
        if oc_branch:
            add_oc_buffers(self)
        self.use_dsn = use_dsn
        if use_dsn:
            # registered last, so the seeded init of every other module
            # draws what it draws without the head
            self.dsn = DSNHead(net.stage_channels[2], num_classes)
        self.eval()

    @staticmethod
    def build_trunk(trunk: str, wt_layer: Tuple[int, ...], variant: str) -> nn.Module:
        """The trunk whose ``layer0``..``layer4`` the model takes: one of the
        nine ResNets (``nn/resnet.py``); a zoo-only trunk raises the JAX
        package's ValueError."""
        return build_trunk(trunk, wt_layer=wt_layer, variant=variant)

    def _np_plus(self, feat: torch.Tensor, noise) -> torch.Tensor:
        return np_plus(feat, noise, self.np_std, self.np_scale)

    def forward(self, x: torch.Tensor, valid_hw: Optional[Tuple[int, int]] = None,
                impl: Optional[str] = None,
                perturb: Optional[PerturbArgs] = None,
                dropout: Union[torch.Generator, torch.Tensor, None] = None,
                hw: Optional[Tuple[int, int]] = None):
        """``valid_hw`` = (vh, vw) in input pixels: the valid extent when
        ``x`` was bottom/right zero-padded to a shape bucket; restricts
        ASPP's image pooling to real pixels. ``impl="plain"`` routes every
        resize through its plain version (kernel-vs-plain checks only).
        ``perturb`` is read in train mode only, and ``dropout`` (the DSN
        head's keep mask or its generator, ``nn.deeplab.dropout``) in train
        mode with ``use_dsn`` only. ``hw``: the global (h, w) of the image
        whose band of rows ``x`` is, under spatial parallelism (None: ``x``
        is the whole image)."""
        with image_scope(x, hw) as size, channels():
            return self._forward(x, size, valid_hw, impl, perturb, dropout)

    def _forward(self, x, hw, valid_hw, impl, perturb, dropout):
        h, w = hw
        perturbing = self.training and perturb is not None
        if perturbing and not self.oc_branch:
            raise ValueError("a perturbed forward needs the OC buffers: build "
                             "the model with oc_branch=True")
        xp = self.layer0(x)
        feat = xp
        oc_dec = None
        chans = active_channels()
        whole, own = (lambda t: t, lambda t: t) if chans is None else (chans.whole, chans.own)
        if perturbing:
            # NP+ and the OC branch both read the unperturbed stem features
            # (deepv3.py:317-320)
            if perturb.gate_np:
                feat = self._np_plus(xp, perturb.np0)
            use_dec = perturb.gate_dec and self.hrfp_plus
            if perturb.gate_oc or use_dec:
                params = oc_params(self)
                # channels-last for the decoder half, NCHW for the injection
                layouts = ((NHWC,) if perturb.gate_oc else ()) + ((NCHW,) if use_dec else ())
                maps = oc_encode(params, whole(xp), (h, w), self.oc_scales_enc, impl, layouts)
                if perturb.gate_oc:
                    feat = own(oc_decode(params, maps[0], (h, w), self.oc_scales_dec,
                                         impl)) + feat
                if use_dec:
                    oc_dec = maps[-1]
        feat = self.layer1(feat)
        if perturbing and perturb.gate_np:
            feat = self._np_plus(feat, perturb.np1)
        low_level = feat
        aux_in = self.layer3(self.layer2(feat))
        feat = self.layer4(aux_in)
        if valid_hw is not None:
            os_ = variant_output_stride(self.variant)
            valid_hw = tuple((int(v) + os_ - 1) // os_ for v in valid_hw)
        feat = self.aspp(feat, valid_hw=valid_hw, impl=impl)
        dec1 = self.decode(feat, low_level, impl=impl)
        if oc_dec is not None:
            # the decoder injection at half resolution (deepv3.py:355-360)
            dec1 = resize_bilinear_align_corners(dec1, (int(h / 2), int(w / 2)), impl)
            dec1 = own(oc_dec) + dec1
        logits = resize_bilinear_align_corners(self.final2(dec1), (h, w), impl)
        if not self.training:
            return logits.float()
        if self.use_dsn:
            return logits, self.dsn(aux_in, dropout).float()
        return logits


@contextlib.contextmanager
def image_scope(x: torch.Tensor, hw: Optional[Tuple[int, int]]
                ) -> Iterator[Tuple[int, int]]:
    """The global (h, w) of the image whose band of rows ``x`` is, inside
    the band scope of that image (``core/mesh.py::bands``); ``x``'s own
    size, and no scope, for ``hw`` None."""
    if hw is None:
        yield x.shape[2], x.shape[3]
        return
    with bands(*hw) as scope:
        if scope is None and tuple(x.shape[2:]) != tuple(hw):
            raise ValueError(f"hw {tuple(hw)} for an input of {tuple(x.shape[2:])} "
                             f"without spatial parallelism")
        yield int(hw[0]), int(hw[1])


def build_mrfp(device, generator: Optional[torch.Generator] = None,
               **kw) -> MRFP:
    """An eval-mode MRFP on ``device``; with ``generator``, seeded random
    weights (drawn on the CPU, so the same on every device)."""
    model = MRFP(**kw)
    if generator is not None:
        init_random_(model, generator)
    return model.to(device)
