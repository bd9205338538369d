"""The DeepV3Plus zoo: DeepLabV3+ over any of the zoo's 15 trunks with the
whitening plan, NCHW (mrfp_tpu/models/deepv3_zoo.py; reference
network/deepv3.py:103-779).

``DeepV3Plus`` is the port's ``MRFP`` without the perturbation: the same
ASPP, decoder, classifier and DSN head under the reference's keys, over
the nine ResNets (``nn/resnet.py``), MobileNetV2, ShuffleNetV2 x1.0,
MNASNet 0.5/1.0 or SE-ResNeXt-50/101 (``ZOO_TRUNKS``), each of which
exposes ``layer0``..``layer4``, so one forward and one
``state_dict_from_jax`` serve them all. The heads read the trunk's widths.
As in JAX, MNASNet and SE-ResNeXt read no ``wt_layer``, and SE-ResNeXt
takes no ``variant``: its layer4 is at stride 32 while the ASPP's rates
and the ``valid_hw`` ceiling follow the factory's D16 (ROADMAP C12).

The forward collects the whitening maps of iw codes 1 and 2 (``w_arr``,
before the ReLU, in the order the modules run) in train mode and in the
statistics pass; the eval
forward collects none and returns the logits alone, so a ``torch.export``
trace of it passes no list and keeps no state.

The ISW/IRW state is host numpy (``nn/cov_settings.py``): ``covstat_update``
takes each map's per-sample covariance and its variance over the batch on
the map's device, in fp64, and copies only the C x C result to the host,
where the JAX package copies the whole maps.

``whitening_loss_from_cov`` and the 23 factory names (``DeepR50V3PlusD``,
...) are the JAX package's.

Under spatial parallelism (``core/mesh.py``) the forward takes this rank's
band of rows and ``hw=``, as ``MRFP.forward`` does: every map is a band,
the whitening maps in ``w_arr`` too, and ``covariance_variance`` sums the
bands' ``f f^T`` over the spatial group before it divides.
``deepest_rows`` bounds the split by the trunk's smallest map.

Under tensor parallelism (``core/mesh.py``) a model that
``weights.shard_model`` cut runs its forward in a channel scope, as
``MRFP.forward`` does: every map is this rank's slice of its channels
(whole where M does not divide its width), the heads are ``MRFP``'s, and
the whitening maps in ``w_arr`` are gathered whole (``nn.norms.apply_iw``),
so the loss and ``covstat_update`` read the whole C x C covariances on
every rank. A whole model under a model axis (the statistics pass of
``cli.train_zoo``, which runs on the gathered state before the step) runs
without the scope, as one process does.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from mrfp_tpu_torch.core.mesh import active_bands, channels
from mrfp_tpu_torch.models.mrfp import MRFP, image_scope
from mrfp_tpu_torch.nn.cov_settings import CovMatrixIRW, CovMatrixISW
from mrfp_tpu_torch.nn.mnasnet import mnasnet0_5, mnasnet1_0
from mrfp_tpu_torch.nn.mobilenet import MobileNetV2
from mrfp_tpu_torch.nn.norms import collects_map
from mrfp_tpu_torch.nn.resnet import build_trunk, variant_output_stride
from mrfp_tpu_torch.nn.seresnext import se_resnext50_32x4d, se_resnext101_32x4d
from mrfp_tpu_torch.nn.shufflenet import ShuffleNetV2
from mrfp_tpu_torch.ops.resize import resize_bilinear_align_corners
from mrfp_tpu_torch.parallel.dist import all_reduce_sum
from mrfp_tpu_torch.train.losses import instance_whitening_loss

# trunk -> the channels of the seven wt_layer slots, which size the cov
# machinery (mrfp_tpu/models/deepv3_zoo.py:38-71)
SLOT_CHANNELS = {
    "resnet-18": (0, 0, 64, 64, 128, 256, 512),
    "resnet-34": (0, 0, 64, 64, 128, 256, 512),
    "resnet-50": (0, 0, 64, 256, 512, 1024, 2048),
    "resnet-101": (64, 64, 128, 256, 512, 1024, 2048),
    "resnet-152": (0, 0, 64, 256, 512, 1024, 2048),
    "resnext-50": (0, 0, 64, 256, 512, 1024, 2048),
    "resnext-101": (0, 0, 64, 256, 512, 1024, 2048),
    "wide_resnet-50": (0, 0, 64, 256, 512, 1024, 2048),
    "wide_resnet-101": (0, 0, 64, 256, 512, 1024, 2048),
    "shufflenetv2": (0, 0, 24, 116, 232, 464, 1024),
    "mobilenetv2": (0, 0, 16, 32, 64, 320, 1280),
    "mnasnet_05": (0, 0, 8, 24, 48, 160, 1280),
    "mnasnet_10": (0, 0, 16, 40, 96, 320, 1280),
    "se_resnext-50": (0, 0, 64, 256, 512, 1024, 2048),
    "se_resnext-101": (0, 0, 64, 256, 512, 1024, 2048),
}
# the trunks other than the ResNets -> builder(wt_layer, variant)
# (mrfp_tpu/models/deepv3_zoo.py:85-102)
ZOO_TRUNKS = {
    "shufflenetv2": lambda wt, variant: ShuffleNetV2(wt_layer=wt, variant=variant),
    "mobilenetv2": lambda wt, variant: MobileNetV2(wt_layer=wt, variant=variant),
    "mnasnet_05": lambda wt, variant: mnasnet0_5(variant=variant),
    "mnasnet_10": lambda wt, variant: mnasnet1_0(variant=variant),
    "se_resnext-50": lambda wt, variant: se_resnext50_32x4d(),
    "se_resnext-101": lambda wt, variant: se_resnext101_32x4d(),
}


def check_zoo_trunk(trunk: str) -> None:
    """ValueError for a name that is no zoo trunk."""
    if trunk not in SLOT_CHANNELS:
        raise ValueError(f"unknown trunk {trunk!r}; have {sorted(SLOT_CHANNELS)}")


@functools.lru_cache(maxsize=None)
def iw_slots(trunk: str) -> Tuple[int, ...]:
    """The ``wt_layer`` slots whose code ``trunk`` reads, as its builder
    places iw layers: the others take none, in JAX too (a ResNet's stem
    slots 0-1 exist only in resnet-101's deep stem; MNASNet and SE-ResNeXt
    read none). Found by building the trunk on the meta device with a
    whitening code in one slot at a time."""
    def whitens(slot: int) -> bool:
        with torch.device("meta"):
            net = DeepV3Plus.build_trunk(trunk, tuple(int(i == slot) for i in range(7)), "D16")
        return any(collects_map(m) for m in net.modules())
    return tuple(slot for slot in range(7) if whitens(slot))


@functools.lru_cache(maxsize=None)
def deepest_rows(trunk: str, variant: str, h: int) -> int:
    """The rows of ``trunk``'s smallest map (layer4's) for an input of
    ``h`` rows, from a forward of the trunk on the meta device: every
    trunk's own strides and pools, SE-ResNeXt's ceil-mode stem pool and
    its stride 32 whatever the variant (ROADMAP C12) included. A spatial
    split cannot exceed it."""
    with torch.device("meta"):
        net = DeepV3Plus.build_trunk(trunk, (0,) * 7, variant).eval()
        x = torch.empty(1, 3, h, h)
        for k in range(5):
            x = getattr(net, f"layer{k}")(x)
    return int(x.shape[2])


class DeepV3Plus(MRFP):
    """DeepLabV3+ with a per-slot whitening plan and the DSN head (on by
    default, network/deepv3.py:417-424). ``forward`` returns, in train mode,
    ``{"logits", "w_arr", "dsn"}`` (fp32 logits at the input's size, the
    whitening maps, fp32 DSN logits at layer3's size when ``use_dsn``);
    with ``cal_covstat``, ``{"w_arr"}`` alone, after layer4; in eval mode,
    the fp32 logits. On a band of rows (``hw=``) each of them is the band's
    rows of the whole image's."""

    def __init__(self, num_classes: int = 19, trunk: str = "resnet-101",
                 variant: str = "D", wt_layer: Tuple[int, ...] = (0,) * 7,
                 use_dsn: bool = True):
        super().__init__(num_classes=num_classes, trunk=trunk, variant=variant,
                         wt_layer=tuple(wt_layer), oc_branch=False, hrfp_plus=False,
                         use_dsn=use_dsn)
        self.trunk, self.wt_layer = trunk, tuple(wt_layer)

    @staticmethod
    def build_trunk(trunk: str, wt_layer: Tuple[int, ...], variant: str) -> nn.Module:
        """A ResNet (``nn/resnet.py``) or one of ``ZOO_TRUNKS``."""
        if trunk in ZOO_TRUNKS:
            return ZOO_TRUNKS[trunk](tuple(wt_layer), variant)
        check_zoo_trunk(trunk)
        return build_trunk(trunk, wt_layer=wt_layer, variant=variant)

    def forward(self, x: torch.Tensor, valid_hw: Optional[Tuple[int, int]] = None,
                impl: Optional[str] = None, cal_covstat: bool = False,
                dropout: Union[torch.Generator, torch.Tensor, None] = None,
                hw: Optional[Tuple[int, int]] = None):
        """``valid_hw``, ``impl``, ``dropout`` and ``hw`` as in
        ``MRFP.forward``."""
        sharded = bool(getattr(self, "tp_keys", None))
        with image_scope(x, hw) as size, channels() if sharded else contextlib.nullcontext():
            return self._zoo_forward(x, size, valid_hw, impl, cal_covstat, dropout)

    def _zoo_forward(self, x, hw, valid_hw, impl, cal_covstat, dropout):
        h, w = hw
        w_arr: Optional[list] = [] if (self.training or cal_covstat) else None
        low_level = self.layer1(self.layer0(x, w_arr=w_arr), w_arr=w_arr)
        aux_in = self.layer3(self.layer2(low_level, w_arr=w_arr), w_arr=w_arr)
        feat = self.layer4(aux_in, w_arr=w_arr)
        if cal_covstat:
            # the statistics pass needs only the maps (network/deepv3.py:534-545)
            return {"w_arr": w_arr}
        if valid_hw is not None:
            os_ = variant_output_stride(self.variant)
            valid_hw = tuple((int(v) + os_ - 1) // os_ for v in valid_hw)
        feat = self.aspp(feat, valid_hw=valid_hw, impl=impl)
        dec1 = self.decode(feat, low_level, impl=impl)
        logits = _at_least_fp32(resize_bilinear_align_corners(self.final2(dec1), (h, w), impl))
        if not self.training:
            return logits
        out: Dict[str, object] = {"logits": logits, "w_arr": w_arr}
        if self.use_dsn:
            out["dsn"] = _at_least_fp32(self.dsn(aux_in, dropout))
        return out


def _at_least_fp32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in fp32, or in fp64 for an fp64 model (a reference step)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def build_cov_layers(trunk: str, wt_layer: Sequence[int], relax_denom: float = 0.0,
                     clusters: int = 50) -> List:
    """Host-side ISW/IRW state per instrumented slot, in slot order
    (network/deepv3.py:456-467)."""
    check_zoo_trunk(trunk)
    in_ch = SLOT_CHANNELS[trunk]
    layers = []
    for i, code in enumerate(wt_layer):
        if code == 1:
            layers.append(CovMatrixIRW(dim=in_ch[i], relax_denom=relax_denom))
        elif code == 2:
            layers.append(CovMatrixISW(dim=in_ch[i], relax_denom=relax_denom,
                                       clusters=clusters))
    return layers


def covariance_variance(f_map: torch.Tensor, eps: float = 1e-5,
                        off_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """One map's variance of covariance (network/deepv3.py:534-544): per
    sample ``f_cor = f f^T / (HW - 1) + eps I`` over the (C, HW) map, times
    ``off_mask`` where given, then its variance over the batch (ddof 1).
    Taken in fp64 on the map's device; the fp32 C x C result comes back.
    On a band of rows (``core/mesh.py``) the bands' products are summed
    over the spatial group and divided by the global HW - 1."""
    n, c, h, w = f_map.shape
    f = f_map.detach().to(torch.float64).reshape(n, c, h * w)
    f_cor = torch.bmm(f, f.transpose(1, 2))
    bands = active_bands()
    if bands is not None:
        h = bands.height(h, w)
        all_reduce_sum(f_cor, bands.group)
    f_cor = f_cor / (h * w - 1)
    f_cor = f_cor + eps * torch.eye(c, dtype=torch.float64, device=f.device)
    if off_mask is not None:
        f_cor = f_cor * torch.as_tensor(off_mask, dtype=torch.float64, device=f.device)
    return f_cor.var(dim=0, unbiased=True).to(torch.float32).cpu().numpy()


def covstat_update(cov_layers: List, w_arr: Sequence[torch.Tensor],
                   eps: float = 1e-5) -> None:
    """One covstat accumulation step: each map's variance of covariance
    (off-diagonal only, where the layer has a ``reversal_eye``) into its
    layer. An IRW layer cannot take it: it has no
    ``set_variance_of_covariance`` in either package, and the JAX package
    fails here with an AttributeError (ROADMAP C6)."""
    for layer, f_map in zip(cov_layers, w_arr):
        if not hasattr(layer, "set_variance_of_covariance"):
            raise ValueError(
                f"{type(layer).__name__} takes no statistics pass: IRW (iw code 1) has a "
                f"fixed mask, and the JAX package's covstat_update fails on it with an "
                f"AttributeError (ROADMAP C6); use ISW (code 2) for --use-wtloss")
        layer.set_variance_of_covariance(
            covariance_variance(f_map, eps, getattr(layer, "reversal_eye", None)))


def whitening_loss_from_cov(w_arr: Sequence[torch.Tensor], cov_layers: List) -> torch.Tensor:
    """The train-time wt_loss with each layer's own mask, count and margin
    (network/deepv3.py:561-568), averaged over the maps."""
    masks, margins, nrcs = [], [], []
    for layer in cov_layers:
        _eye, mask, margin, nrc = layer.get_mask_matrix()
        masks.append(mask)
        nrcs.append(float(nrc))
        margins.append(float(margin))
    loss = instance_whitening_loss(list(w_arr), masks, margins, nrcs)
    return loss / max(len(w_arr), 1)


# the reference's factory names (network/deepv3.py:606-779) -> (trunk, variant)
FACTORIES = {
    "DeepR18V3PlusD": ("resnet-18", "D"),
    "DeepR50V3PlusD": ("resnet-50", "D16"),
    "DeepR50V3PlusD_OS8": ("resnet-50", "D"),
    "DeepR101V3PlusD": ("resnet-101", "D16"),
    "DeepR101V3PlusD_OS8": ("resnet-101", "D"),
    "DeepR152V3PlusD_OS8": ("resnet-152", "D"),
    "DeepResNext50V3PlusD": ("resnext-50", "D16"),
    "DeepResNext101V3PlusD": ("resnext-101", "D16"),
    "DeepResNext101V3PlusD_OS8": ("resnext-101", "D"),
    "DeepResNext101V3PlusD_OS4": ("resnext-101", "D4"),
    "DeepWideResNet50V3PlusD": ("wide_resnet-50", "D16"),
    "DeepWideResNet50V3PlusD_OS8": ("wide_resnet-50", "D"),
    "DeepWideResNet101V3PlusD": ("wide_resnet-101", "D16"),
    "DeepWideResNet101V3PlusD_OS8": ("wide_resnet-101", "D"),
    "DeepShuffleNetV3PlusD": ("shufflenetv2", "D16"),
    "DeepShuffleNetV3PlusD_OS8": ("shufflenetv2", "D"),
    "DeepShuffleNetV3PlusD_OS32": ("shufflenetv2", "D32"),
    "DeepMobileNetV3PlusD": ("mobilenetv2", "D16"),
    "DeepMobileNetV3PlusD_OS8": ("mobilenetv2", "D"),
    "DeepMNASNet05V3PlusD": ("mnasnet_05", "D16"),
    "DeepMNASNet10V3PlusD": ("mnasnet_10", "D16"),
    "DeepSEResNext50V3PlusD": ("se_resnext-50", "D16"),
    "DeepSEResNext101V3PlusD": ("se_resnext-101", "D16"),
}


def arch_trunk(arch: str) -> Tuple[str, str]:
    """A factory name's (trunk, variant); ValueError for an unknown name."""
    if arch not in FACTORIES:
        raise ValueError(f"unknown arch {arch!r}; have {sorted(FACTORIES)}")
    return FACTORIES[arch]


def get_net(arch: str, num_classes: int = 19, wt_layer: Sequence[int] = (0,) * 7,
            use_dsn: bool = True) -> DeepV3Plus:
    """network/__init__.py:13-23: a factory name -> its model."""
    trunk, variant = arch_trunk(arch)
    return DeepV3Plus(num_classes=num_classes, trunk=trunk, variant=variant,
                      wt_layer=tuple(wt_layer), use_dsn=use_dsn)
