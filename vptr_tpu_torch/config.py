"""Configuration system: typed dataclasses + named presets + CLI overrides.

The PyTorch port keeps its own copy of ``vptr_tpu/config.py`` (it imports
nothing from the JAX package); ``tests/test_torch_port_config.py`` checks
that every preset of the two is equal, field for field. Fields that only
the JAX package uses (``mesh``, ``rng_impl``, ``steps_per_dispatch``, ...)
are kept so configs round-trip; of the kernel routes (``fused_*``) the port
reads ``fused_attention``, ``fused_full`` and ``fused_residual`` and refuses
the ones it has not ported yet.

The reference hard-codes every hyperparameter inside each train script's
``__main__`` block (reference: train_FAR.py:154-176, train_AutoEncoder.py:106-160,
train_NAR.py:160-216). Here they are first-class config objects; the five
BASELINE.json configs ship as named presets.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _replace_from_dict(obj, d: dict):
    """Recursively apply a (possibly nested) dict of overrides to a dataclass."""
    updates = {}
    for k, v in d.items():
        if not hasattr(obj, k):
            raise KeyError(f"unknown config field {k!r} for {type(obj).__name__}")
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            updates[k] = _replace_from_dict(cur, v)
        else:
            updates[k] = v
    return dataclasses.replace(obj, **updates)


@dataclass(frozen=True)
class AutoencoderConfig:
    """Stage-1 ResNet autoencoder (reference: model/ResNetAutoEncoder.py:8-101)."""

    img_channels: int = 1
    ngf: int = 64                       # base filter count
    feat_dim: int = 528                 # latent channels (reference: train_FAR.py:158)
    n_downsampling: int = 3             # 64x64 -> 8x8
    n_res_blocks: int = 9               # reference: ResNetAutoEncoder.py:44
    padding_type: str = "reflect"       # reflect | replicate | zero
    norm: str = "batch"                 # batch | group | layer (batch = reference parity)
    out_layer: str = "sigmoid"          # sigmoid (MNIST) | tanh (KTH/BAIR); train_FAR.py:180
    use_dropout: bool = False
    init_type: str = "normal"           # normal | xavier | kaiming | orthogonal
                                        # (reference: ResNetAutoEncoder.py:160-189)


@dataclass(frozen=True)
class DiscriminatorConfig:
    """PatchGAN discriminator (reference: model/VPTR_modules.py:49-95)."""

    img_channels: int = 1
    ndf: int = 64
    n_layers: int = 3
    norm: str = "batch"
    init_type: str = "normal"


@dataclass(frozen=True)
class TransformerConfig:
    """Stage-2 VidHRFormer (reference: model/VPTR_modules.py:98-197)."""

    variant: str = "far"                # far | nar
    num_past_frames: int = 10
    num_future_frames: int = 10
    enc_h: int = 8
    enc_w: int = 8
    d_model: int = 528
    n_heads: int = 8
    num_encoder_layers: int = 12        # FAR default (train_FAR.py:192); NAR uses 4-6
    num_decoder_layers: int = 8         # NAR only (train_NAR.py:190)
    window_size: int = 4
    spatial_ffn_hidden_ratio: int = 4
    dropout: float = 0.1
    attention_dropout: Optional[float] = None  # None -> same as dropout;
                                        # the fused kernels support dropout
                                        # in-kernel, so 0 is an ablation
                                        # knob, not a fusion requirement
    drop_path: float = 0.1              # reference ties drop_path = dropout (VPTR_modules.py:114)
    rpe: bool = False                   # relative position bias in window attention
    tslma: bool = False                 # NAR enc-dec attn: TSLMA vs full temporal MHA
    # Kernel routes. The JAX package picked these defaults by measurement
    # on a TPU; the port reads fused_attention / fused_full / fused_residual
    # and refuses the routes whose kernels are not ported yet.
    fused_attention: bool = True        # attention sublayers on the kernels
    fused_full: bool = True             # whole window sublayer (LayerNorm +
                                        # q/k/v/out projections) in one kernel
    fused_full_blocks: Tuple[int, int] = (64, 32)
                                        # (fwd, bwd) batch tiles of the JAX
                                        # package's fused window kernel
    fused_full_temporal: bool = False   # fused_full for the temporal sublayer
    fused_residual: bool = False        # fold the window sublayer's residual
                                        # add + DropPath into the kernel
    fused_dw: bool = False              # fused norm1+GELU+dw3x3+norm2+GELU+
                                        # drop between the conv FFN's GEMMs
    fused_ffn: bool = False             # fused LN+fc1+GELU+drop+fc2 for the
                                        # linear FFN sublayer
    fused_conv_ffn: bool = False        # fused conv+LayerNormHWC+GELU for the
                                        # conv-FFN fc1/fc2 stages
    sequence_parallel: bool = False     # shard the temporal-attention token
                                        # columns over the 'model' mesh axis
                                        # (alternative to tensor parallel)
    remat: bool = False                 # jax.checkpoint each block: trade
                                        # recompute for HBM (enables batch>=32)
    scan_layers: bool = False           # nn.scan the FAR block stack: ~12x
                                        # smaller HLO, much faster compiles;
                                        # changes the param tree (stacked)
    conv_ffn_norm: str = "auto"         # auto: layer for FAR/NAR-dec, batch for NAR-enc
                                        # (reference: VidHRFormer_modules.py:40-43,390)


@dataclass(frozen=True)
class OptimConfig:
    optimizer: str = "adamw"            # adam | adamw
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    weight_decay: float = 0.01
    max_grad_norm: Optional[float] = 1.0
    schedule: str = "constant"          # constant | noam
    noam_factor: float = 2.0
    noam_warmup_steps: int = 4000
    mu_dtype: str = "bfloat16"          # dtype of Adam's FIRST moment (the
                                        # JAX package's default; "float32"
                                        # matches the reference's torch AdamW;
                                        # the second moment stays f32)


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "mnist"              # mnist | kth | bair | synthetic
    data_dir: str = ""
    batch_size: int = 10
    num_past_frames: int = 10
    num_future_frames: int = 10
    test_past_frames: int = 10
    test_future_frames: int = 10
    img_size: int = 64
    img_channels: int = 1
    # per-dataset normalization stats (reference: utils/dataset.py:23,49-50)
    mean: Tuple[float, ...] = (0.0,)
    std: Tuple[float, ...] = (1.0,)
    random_flip: bool = True            # one flip decision per clip (utils/dataset.py:393-413)
    num_workers: int = 4
    prefetch: int = 2
    # synthetic stand-in generator (used when data_dir is empty/missing):
    # "dynamic" = accelerated, colliding, occluding digits + pixel noise —
    # hard enough that rollout error accumulates and the FAR/NAR rollout
    # modes separate; "linear" = the trivially-extrapolatable smoke task
    synthetic_motion: str = "dynamic"
    synthetic_noise: float = 0.03
    synthetic_digits: int = 3


@dataclass(frozen=True)
class LossConfig:
    lam_gan: Optional[float] = None     # None = no GAN term
    gan_mode: str = "vanilla"           # vanilla | lsgan | wgangp
    lam_nce: Optional[float] = None     # NAR only; 0.1 in train_NAR.py:174
    nce_temperature: float = 0.07       # BiPatchNCE class default
                                        # (criterion.py:211). NOTE: both
                                        # reference NAR train scripts override
                                        # this to 1.0 (train_NAR.py:213,
                                        # train_NAR_mp.py:128) — every NAR
                                        # preset ships nce_temperature=1.0;
                                        # 0.07 here mirrors only the class
                                        # default for ad-hoc configs
    gdl_alpha: float = 1.0
    temporal_weight: bool = False       # exp-increasing per-step weight (criterion.py:8-13)


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout. data = DP axis, model = TP axis."""

    data: int = -1                      # -1: all devices on the data axis
    model: int = 1


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "experiment"
    stage: str = "ae"                   # ae | far | nar
    seed: int = 2021
    rng_impl: str = "rbg"               # JAX PRNG: rbg | threefry2x32
    epochs: int = 100
    steps_per_epoch: Optional[int] = None   # None: one pass over the dataset
    steps_per_dispatch: int = 0         # JAX trainer: train steps folded into
                                        # one jitted lax.scan dispatch (0 = auto)
    val_per_epochs: int = 4
    ckpt_dir: str = "ckpts"
    ckpt_keep: int = 3
    ckpt_per_epochs: int = 1            # save cadence; the final epoch of a
                                        # train() call always saves
    resume: bool = True
    ae_ckpt: Optional[str] = None       # stage-2: path of the stage-1 AE checkpoint
    log_every: int = 50
    profile_dir: Optional[str] = None   # jax.profiler trace output (epoch 1)
    profile_steps: int = 5
    debug_nans: bool = False            # jax nan-checking mode (the JAX
                                        # equivalent of a sanitizer run;
                                        # SURVEY.md §5 race-detection row)
    dtype: str = "bfloat16"             # compute dtype; params always float32
    ae: AutoencoderConfig = field(default_factory=AutoencoderConfig)
    disc: DiscriminatorConfig = field(default_factory=DiscriminatorConfig)
    transformer: TransformerConfig = field(default_factory=TransformerConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    optim_d: OptimConfig = field(default_factory=lambda: OptimConfig(
        optimizer="adam", lr=2e-4, b1=0.5, b2=0.999, max_grad_norm=None))
    data: DataConfig = field(default_factory=DataConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def replace(self, **kwargs) -> "ExperimentConfig":
        return dataclasses.replace(self, **kwargs)

    def override(self, d: dict) -> "ExperimentConfig":
        return _replace_from_dict(self, d)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @property
    def total_frames(self) -> int:
        return self.data.num_past_frames + self.data.num_future_frames


# ---------------------------------------------------------------------------
# Named presets — the five BASELINE.json configs.
# ---------------------------------------------------------------------------

def _mnist_data(batch: int) -> DataConfig:
    return DataConfig(dataset="mnist", batch_size=batch, img_channels=1,
                      mean=(0.0,), std=(1.0,))


def _kth_data(batch: int) -> DataConfig:
    # KTH stats: utils/dataset.py:23
    return DataConfig(dataset="kth", batch_size=batch, img_channels=1,
                      mean=(0.6013795,), std=(2.7570653,))


def _bair_data(batch: int, test_future: int = 28) -> DataConfig:
    # BAIR stats: utils/dataset.py:49-50; 2 past + 10 future (utils/dataset.py:55-56)
    return DataConfig(dataset="bair", batch_size=batch, img_channels=3,
                      num_past_frames=2, num_future_frames=10,
                      test_past_frames=2, test_future_frames=test_future,
                      mean=(0.61749697, 0.6050092, 0.52180636),
                      std=(2.1824553, 2.1553133, 1.9115673))


_PRESETS = {}


def _register(name: str, cfg: ExperimentConfig):
    _PRESETS[name] = cfg


# 1) Stage-1 AE on MovingMNIST (reference: train_AutoEncoder.py:106-160)
_register("ae_mnist", ExperimentConfig(
    name="ae_mnist", stage="ae", epochs=50,
    ae=AutoencoderConfig(img_channels=1, out_layer="sigmoid"),
    disc=DiscriminatorConfig(img_channels=1),
    optim=OptimConfig(optimizer="adam", lr=2e-4, b1=0.5, b2=0.999,
                      weight_decay=0.0, max_grad_norm=None),
    data=_mnist_data(32),
    loss=LossConfig(lam_gan=0.01, gan_mode="vanilla"),
))

# 1b) Stage-1 AE on KTH / BAIR (train_AutoEncoder recipe, other datasets)
_register("ae_kth", ExperimentConfig(
    name="ae_kth", stage="ae", epochs=50,
    ae=AutoencoderConfig(img_channels=1, out_layer="tanh"),
    disc=DiscriminatorConfig(img_channels=1),
    optim=OptimConfig(optimizer="adam", lr=2e-4, b1=0.5, b2=0.999,
                      weight_decay=0.0, max_grad_norm=None),
    data=_kth_data(32),
    loss=LossConfig(lam_gan=0.01, gan_mode="vanilla"),
))

# BAIR builds the AE with ZERO padding, not the reflect default — every
# reference BAIR script does (train_NAR.py:171,188-189, train_FAR_mp.py:293);
# and NAR presets train BiPatchNCE at temperature 1.0, the constant both NAR
# scripts pass explicitly (train_NAR.py:213, train_NAR_mp.py:128), overriding
# the class's 0.07 default.
_register("ae_bair", ExperimentConfig(
    name="ae_bair", stage="ae", epochs=50,
    ae=AutoencoderConfig(img_channels=3, out_layer="tanh",
                         padding_type="zero"),
    disc=DiscriminatorConfig(img_channels=3),
    optim=OptimConfig(optimizer="adam", lr=2e-4, b1=0.5, b2=0.999,
                      weight_decay=0.0, max_grad_norm=None),
    data=_bair_data(32),
    loss=LossConfig(lam_gan=0.01, gan_mode="vanilla"),
))

# 2) VPTR-NAR MovingMNIST (train_NAR.py:160-216 geometry, MNIST data)
_register("nar_mnist", ExperimentConfig(
    name="nar_mnist", stage="nar", epochs=100,
    ae=AutoencoderConfig(img_channels=1, out_layer="sigmoid"),
    transformer=TransformerConfig(
        variant="nar", num_encoder_layers=4, num_decoder_layers=8,
        rpe=True, dropout=0.1, drop_path=0.1),
    optim=OptimConfig(optimizer="adamw", lr=1e-4, max_grad_norm=1.0),
    data=_mnist_data(16),
    loss=LossConfig(lam_nce=0.1, nce_temperature=1.0),
))

# 3) VPTR-FAR MovingMNIST (reference: train_FAR.py:154-197)
_register("far_mnist", ExperimentConfig(
    name="far_mnist", stage="far", epochs=100,
    ae=AutoencoderConfig(img_channels=1, out_layer="sigmoid"),
    transformer=TransformerConfig(
        variant="far", num_encoder_layers=12, rpe=False,
        dropout=0.1, drop_path=0.1),
    optim=OptimConfig(optimizer="adamw", lr=1e-4, max_grad_norm=1.0),
    data=_mnist_data(10),
    loss=LossConfig(lam_gan=None),
))

# 4) VPTR-NAR KTH (10 -> 20/40 long-horizon eval). 64x64 frames: the
#    reference's KTH pipeline center-crops 120 and resizes to 64
#    (reference: utils/dataset.py:24-25), so this is the parity reading of
#    "VPTR-NAR KTH" even though BASELINE.json names 128x128 (see nar_kth_128).
_register("nar_kth", ExperimentConfig(
    name="nar_kth", stage="nar", epochs=100,
    ae=AutoencoderConfig(img_channels=1, out_layer="tanh"),
    transformer=TransformerConfig(
        variant="nar", num_encoder_layers=4, num_decoder_layers=8, rpe=True),
    optim=OptimConfig(optimizer="adamw", lr=1e-4, max_grad_norm=1.0),
    data=dataclasses.replace(_kth_data(16), test_future_frames=40),
    loss=LossConfig(lam_nce=0.1, nce_temperature=1.0),
))

# 4c) VPTR-NAR KTH at 128x128 — the geometry BASELINE.json's config 4 names
#     literally ("KTH grayscale 128x128, 10 -> 20/40"). No reference script
#     trains this (utils/dataset.py:24-25 resizes KTH to 64), so it has no
#     upstream recipe to cite; it exists so the 16x16-latent path (16
#     windows/frame, geometry-bound frame_queries and pos embeds) is a
#     shipped, tested configuration. Same recipe as nar_kth otherwise.
#     Batch is 8, not nar_kth's 16 (the JAX package's choice, by memory on
#     its TPU; see vptr_tpu/config.py).
_register("nar_kth_128", ExperimentConfig(
    name="nar_kth_128", stage="nar", epochs=100,
    ae=AutoencoderConfig(img_channels=1, out_layer="tanh"),
    transformer=TransformerConfig(
        variant="nar", num_encoder_layers=4, num_decoder_layers=8, rpe=True,
        enc_h=16, enc_w=16),
    optim=OptimConfig(optimizer="adamw", lr=1e-4, max_grad_norm=1.0),
    data=dataclasses.replace(_kth_data(8), img_size=128,
                             test_future_frames=40),
    loss=LossConfig(lam_nce=0.1, nce_temperature=1.0),
))

# 4b) VPTR-NAR BAIR action-free 2 -> 10 train, 2 -> 28 eval — the published
#     headline config (README table, docs/Table2_Corrected.png; recipe
#     train_NAR.py:160-216)
_register("nar_bair", ExperimentConfig(
    name="nar_bair", stage="nar", epochs=100,
    ae=AutoencoderConfig(img_channels=3, out_layer="tanh",
                         padding_type="zero"),
    transformer=TransformerConfig(
        variant="nar", num_past_frames=2, num_future_frames=10,
        num_encoder_layers=4, num_decoder_layers=8, rpe=True),
    optim=OptimConfig(optimizer="adamw", lr=1e-4, max_grad_norm=1.0),
    data=_bair_data(16, test_future=28),
    loss=LossConfig(lam_nce=0.1, nce_temperature=1.0),
))

# 5) VPTR-FAR BAIR with data-parallel mesh (train_FAR_mp.py:295-316 parity)
_register("far_bair_dp", ExperimentConfig(
    name="far_bair_dp", stage="far", epochs=100,
    ae=AutoencoderConfig(img_channels=3, out_layer="tanh",
                         padding_type="zero"),
    transformer=TransformerConfig(
        variant="far", num_past_frames=2, num_future_frames=10,
        num_encoder_layers=12, rpe=False),
    optim=OptimConfig(optimizer="adamw", lr=1e-4, max_grad_norm=1.0),
    data=_bair_data(64),
    loss=LossConfig(lam_gan=None),
    mesh=MeshConfig(data=-1, model=1),
))


def get_preset(name: str) -> ExperimentConfig:
    if name not in _PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(_PRESETS)}")
    return _PRESETS[name]


def list_presets():
    return sorted(_PRESETS)
