"""Configuration tree of the port: a copy of mrfp_tpu/core/config.py.

It is a copy because ``mrfp_tpu.core``'s ``__init__`` imports jax. The
knobs and their defaults are the JAX package's, so one recipe names the
same run in both packages. ``MeshConfig`` lays the processes out as the
JAX mesh lays out devices (``core/mesh.py``): data, tensor and spatial
parallelism run one process per card (``parallel/dist.py``), for MRFP
and for the zoo alike. ``trunk`` takes
the nine ResNet trunks for MRFP and the zoo's 15 for ``DeepV3Plus``
(``models/deepv3_zoo.py``), and ``wt_layer`` iw codes 0-5; MRFP raises the
JAX package's ValueError for a zoo-only trunk (``nn/resnet.py``). The zoo's knobs
(``use_wtloss``, ``relax_denom``, ``clusters``, ``wt_reg_weight``) are
read by ``cli/train_zoo.py`` and ``train/zoo_step.py``; ``remat``, a TPU
memory measure, is not read.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture knobs (reference: deepv3.py:160-266, network/deepv3.py:103-300)."""

    num_classes: int = 19
    trunk: str = "resnet-50"          # resnet-18/34/50/101/152, mobilenetv2,
                                      # shufflenetv2, seresnext-50/101, wide_resnet,
                                      # wider_resnet38
    variant: str = "D16"              # D | D4 | D16 | D32 (dilation plan)
    # Per-position whitening plan, 7 slots like the reference wt_layer
    # (network/Resnet.py:519-559): 0 none, 1/2 InstanceWhitening (collect w),
    # 3 InstanceNorm, 4 InstanceNorm(affine), 5 SwitchWhiten(sync).
    wt_layer: Tuple[int, ...] = (0, 0, 4, 4, 4, 0, 0)
    use_wtloss: bool = False          # ISW/IRW whitening loss (zoo path)
    use_dsn_aux: bool = False         # auxiliary DSN head on layer3
    # IRW/ISW knobs (network/cov_settings.py)
    relax_denom: float = 0.0
    clusters: int = 50
    wt_reg_weight: float = 0.6
    # ASPP
    aspp_reduction_dim: int = 256
    # skip connection source: 'conv' uses layer1 (channel 256 for R50)
    hrfp_plus: bool = True            # MRFP+ decoder injection (deepv3.py:355-357)


@dataclasses.dataclass(frozen=True)
class PerturbConfig:
    """MRFP perturbation knobs (reference: deepv3.py:268-357)."""

    enabled: bool = True
    p_oc: float = 0.5                 # gate: OC re-init + stem injection (p)
    p_np: float = 0.5                 # gate: NP+ after layer0 and layer1 (p2)
    p_dec: float = 0.5                # gate: decoder OC injection (p3, MRFP+)
    np_std: float = 0.75              # NP+ alpha/beta std (deepv3.py:274-275)
    np_scale: float = 1.5             # NP+ mean_scale multiplier (deepv3.py:273)
    oc_bn_std: float = 0.5            # OC BN weight ~ N(0, std) (mynn.py:57-74)
    # OC branch geometry (deepv3.py:320-327): nearest-resize scale chain
    oc_scales_enc: Tuple[float, ...] = (1.205, 1.2, 1.2)
    oc_scales_dec: Tuple[float, ...] = (0.838, 0.798)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Data pipeline knobs (reference: main.py:789-796,813-821)."""

    source: str = "gtav"
    base_size: int = 768
    crop_size: int = 768
    eval_size: int = 1536             # Mapillary ResizeHeight/CenterCropPad
    val_size_hw: Tuple[int, int] = (512, 1024)
    batch_size: int = 16
    eval_batch_size: int = 1
    num_workers: int = 8
    ignore_index: int = 255
    # active GTAV train augs (main.py:410-419)
    random_flip: bool = True
    color_jitter: Tuple[float, float, float, float] = (0.5, 0.2, 0.2, 0.3)
    # (brightness, contrast, saturation, hue)
    scale_range: Tuple[float, float] = (0.5, 2.0)
    gaussian_blur: bool = True
    # frequency-domain transforms (dataloaders.py:24-79) — off by default,
    # matching the reference's commented-out pipelines
    freq_transform: Optional[str] = None   # None | 'hpf' | 'lpf' | 'phot'
    # Class-uniform sampling (reference config.py:53-54, consumed nowhere in
    # the live path — schema completeness): fraction of train samples whose
    # scale+crop is centroid-biased toward rare classes via the ClassUniform
    # joint transform (transforms/joint_transforms.py:552-685).
    class_uniform_pct: float = 0.0
    class_uniform_classes: Tuple[int, ...] = (16, 15, 14)  # train/bus/truck
    # Per-batch class-weighted CE (reference config.py:56, dead knob there;
    # semantics follow the RobustNet harness it was inherited from): over
    # the batch's normalised label histogram, w = (hist > 0) * (1 - hist) + 1
    # (train/losses.batch_class_weights).
    batch_weighting: bool = False
    # Border-relaxation knobs (reference config.py:58-64; dead there — its
    # loss consumer was never vendored). Live here: ``jointwtborder``
    # (config.py:121's arg name) switches the main CE to the border-relaxed
    # objective (train/losses.relaxed_cross_entropy), with the multi-hot
    # target built ON DEVICE from the int labels (keeps the uint8 wire;
    # equivalence with RelaxedBoundaryLossToTensor pinned in
    # tests/test_extras.py). The host transform remains for consumers that
    # want precomputed targets.
    jointwtborder: bool = False
    border_window: int = 1
    reduce_border_iter: int = -1
    reduce_border_epoch: int = -1
    strict_border_class: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer / schedule (reference: main.py:826,832-839)."""

    lr: float = 1e-2
    momentum: float = 0.9
    weight_decay: float = 5e-4
    max_iter: int = 40000
    poly_power: float = 0.9
    seed: int = 0
    # mixed precision: params fp32, conv/matmul compute bf16, norms fp32
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # None (f32, torch-bitwise) | 'bfloat16' (half the momentum HBM traffic)
    momentum_dtype: Optional[str] = None
    # fuse bottleneck 1x1-conv + BN-stat epilogues into one Pallas pass
    # (train-path only; A/B'd on TPU — see ops/pallas_dot_stats.py)
    fuse_bn_stats: bool = False
    checkpoint_dir: str = "/tmp/mrfp_tpu_ckpt"
    checkpoint_every: int = 1000
    keep_checkpoints: int = 3
    log_every: int = 50
    remat: bool = False               # jax.checkpoint the backbone stages
    # gradient accumulation: split the step's batch into N sequential
    # microbatches inside one jit (lax.scan). Grads are the mean of the
    # microbatch means (the DDP-average semantics); BN running stats take N
    # sequential EMA updates (what N torch forwards would do). Activations
    # are microbatch-sized — effective batches beyond one chip's HBM.
    accum_steps: int = 1


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Process mesh (mrfp_tpu/core/config.py:135-151). Data parallelism is
    the parity strategy; the 'spatial' axis splits image H across processes,
    each computing its band of rows of every map and fetching the halo rows
    it reads (``core/mesh.py``): for resolutions whose activations exceed
    one card's memory. The 'model' axis (tensor parallelism) splits the
    channels: each process of a model group holds a slice of every conv
    kernel's output channels, its BN affines and statistics and their
    momentum, and computes that slice of every map from the whole input
    map, gathered over the group (MRFP on the ResNet trunks, and the zoo
    over every trunk; a tensor that M does not divide stays whole, and so
    does the map it makes). Rank ``(d * model_parallel + m) * spatial_parallel + s``
    has index d, m, s on the three axes."""

    data_axis: str = "data"
    model_axis: str = "model"
    spatial_axis: str = "spatial"
    # -1 = all processes left over for the data axis
    data_parallel: int = -1
    model_parallel: int = 1
    spatial_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    perturb: PerturbConfig = dataclasses.field(default_factory=PerturbConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def mrfp_plus_config() -> Config:
    """The paper's headline MRFP+ recipe (BASELINE.md reproduction recipe)."""
    return Config()


def mrfp_config() -> Config:
    """MRFP (no decoder injection): p3 gate disabled."""
    c = Config()
    return c.replace(perturb=dataclasses.replace(c.perturb, p_dec=0.0),
                     model=dataclasses.replace(c.model, hrfp_plus=False))


def baseline_config() -> Config:
    """Plain DeepLabV3+ (simpleDeepV3Plus, deepv3.py:370-489): no perturbation."""
    c = Config()
    return c.replace(perturb=dataclasses.replace(c.perturb, enabled=False),
                     model=dataclasses.replace(c.model, hrfp_plus=False))
