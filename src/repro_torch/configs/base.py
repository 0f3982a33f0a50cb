"""Config system: dataclasses + registry for architectures and shapes.

The PyTorch port's own copy of the JAX package's config dataclasses,
field for field, so a configuration means the same thing in both
packages. Every architecture is a ``ModelConfig`` produced by a factory
in ``src/repro_torch/configs/<arch>.py`` and registered under its public
id (``--arch <id>``). Only ResNet-50 is registered in the port so far.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class VisionFrontend:
    """Stub modality frontend (VLM): precomputed patch embeddings."""

    num_patches: int = 576
    patch_dim: int = 1024  # CLIP-L hidden size feeding the projector


@dataclass(frozen=True)
class AudioFrontend:
    """Stub modality frontend (audio): precomputed mel-frame embeddings."""

    num_frames: int = 1500  # 30 s of audio after 2x conv subsampling
    frame_dim: int = 80  # mel bins (pre-conv); stub supplies post-conv embeds


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters. One instance per assigned arch."""

    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm | conv
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None  # default: d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None  # SWA width (mixtral)
    pos_embedding: str = "rope"  # rope | learned | none
    mlp_variant: str = "swiglu"  # swiglu (3 mats) | gelu (2 mats)

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_layer_every: int = 1  # MoE on layers where (i % every == every-1)
    n_shared_experts: int = 0  # llama4-style always-on shared expert

    # --- SSM / hybrid (zamba2-style Mamba2 backbone) ---
    ssm_state: int = 0
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    shared_attn_every: int = 0  # hybrid: insert shared attn block every k
    n_shared_attn_blocks: int = 0  # number of distinct shared blocks cycled

    # --- xLSTM ---
    slstm_every: int = 0  # sLSTM at layers i % every == every-1; rest mLSTM
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0

    # --- encoder-decoder (whisper) ---
    n_encoder_layers: int = 0  # >0 => enc-dec; n_layers = decoder layers

    # --- conv net (resnet50, the paper's own arch) ---
    conv_stages: Tuple[int, ...] = ()  # bottleneck block counts per stage
    conv_width: int = 64
    num_classes: int = 0
    image_size: int = 224
    # fused BN at every BN site: one stats pass + fused
    # normalize/ReLU/residual epilogue + fused backward
    # (kernels/fused_bn.py, --fused-bn)
    fused_bn: bool = False

    # --- modality frontends (stubs per assignment spec) ---
    vision: Optional[VisionFrontend] = None
    audio: Optional[AudioFrontend] = None

    # notes for DESIGN/EXPERIMENTS provenance
    source: str = ""

    def __post_init__(self):
        if self.head_dim is None and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)


# ---------------------------------------------------------------------------
# Shapes (the per-arch input-shape cells)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode
    skip_reason: Optional[str] = None  # e.g. long_500k on full-attention archs


# ---------------------------------------------------------------------------
# Training / parallelism configuration (the paper's recipe knobs)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OptimizerConfig:
    """Paper Appendix A hyper-parameters (defaults are the paper's)."""

    kind: str = "rmsprop_warmup"  # rmsprop_warmup | momentum_sgd | lars
    mu1: float = 0.9  # momentum
    mu2: float = 0.99  # second-moment EMA
    eps: float = 1e-8
    eta_rmsprop: float = 3e-4
    beta_center: float = 10.0  # epochs; alpha_sgd = 1/2 here
    beta_period: float = 5.0
    transition: str = "elu"  # elu (paper) | sudden | linear | sigmoid
    weight_decay: float = 1e-4  # Goyal baseline WD (applied as L2-in-grad)
    base_lr_per_256: float = 0.1  # linear-scaling constant
    schedule: str = "slow_start"  # slow_start | goyal | poly | constant
    warmup_epochs: float = 5.0  # gradual warmup (goyal/poly schedules)
    total_epochs: float = 90.0
    # LARS (You et al.): layer-wise trust-ratio coefficient; poly_power
    # is the "poly" schedule's decay exponent (2 in You/Yamazaki et al.)
    trust_coef: float = 0.001
    poly_power: float = 2.0
    use_fused_kernel: bool = False  # fused update kernel (kernels/fused_update.py)
    # beyond paper: bf16 optimizer state halves m/Delta residency (the
    # update math stays fp32) — what lets 400B fp32-master training fit
    # a single 256-chip pod (EXPERIMENTS.md §Dry-run)
    state_dtype: str = "float32"  # float32 | bfloat16


@dataclass(frozen=True)
class ParallelConfig:
    """How a (arch x shape) cell maps onto the mesh."""

    dp_axes: Tuple[str, ...] = ("data",)  # + ("pod",) on multi-pod
    tp_axis: Optional[str] = "model"
    zero_1: bool = True  # shard optimizer state over dp axes (beyond paper)
    fsdp_params: bool = False  # shard params over dp axes too
    # gradient sync: None | bf16 | f16 (paper: f16) | "<wire>+bucketed"
    # (one collective per fixed-size bucket instead of per leaf,
    # DESIGN.md §2/§6; bucketed applies to the shard_map DP mode)
    compression: Optional[str] = "bf16"
    bucket_bytes: int = 64 * 1024 * 1024  # bucketed sync: bytes/collective
    error_feedback: bool = False  # thread EF residuals through explicit sync
    # launch each bucket's all-reduce as soon as its leaves are produced
    # by the backward pass (ready-order bucketing + staged VJP,
    # DESIGN.md §8); shard_map DP only, requires a staged model
    overlap_comm: bool = False
    # ZeRO reduce-scatter sync (--zero, DESIGN.md §9): psum_scatter each
    # packed bucket, run the optimizer update only on the worker-owned
    # shard of the stream (delta/m sharded over dp), all-gather the
    # updated param slices back. shard_map DP + bucketed compression
    # only; composes with overlap_comm. Distinct from zero_1, which is
    # the GSPMD-mode sharding-constraint flavor of the same idea.
    zero_dp: bool = False
    # hierarchical collective schedule (DESIGN.md §14): split dp_axes at
    # this index into outer (inter-node) / inner (intra-node) stages and
    # run each bucket as intra reduce-scatter -> inter all-reduce ->
    # intra all-gather instead of one flat psum. None = flat. Needs a
    # multi-axis DP mesh with both factors >= 2 and bucketed compression;
    # usually set via launch/train.py --comm-plan (distributed/comm_plan).
    hier_split: Optional[int] = None
    remat: str = "block"  # none | block  (activation checkpoint per layer)
    sequence_sharding: bool = False  # shard seq dim of activations (SP)
    kv_seq_sharding: bool = False  # serve: shard KV cache seq on model


@dataclass(frozen=True)
class InputConfig:
    """Production input-pipeline knobs (DESIGN.md §15).

    ``fused`` moves augmentation + normalize + compute-dtype cast into a
    single on-device kernel pass (kernels/fused_input.py) applied inside
    the shard_map step; off, the same transform runs on the host feed
    workers (pipeline.AugmentedSource) — the two paths are parity-tested
    (tests/test_fused_input.py)."""

    augment: bool = True  # per-sample flip + shift (crop proxy) on train
    fused: bool = False  # on-device augment+normalize+cast kernel
    num_workers: int = 1  # host producer threads (--data-workers)
    depth: int = 4  # reorder-buffer bound, steps ahead of consumer
    device_ahead: int = 1  # steps staged on device past the current one
    num_hosts: int = 1  # per-host input sharding (--host-shard h/N)
    host_id: int = 0
    max_shift: int = 4  # translation-augmentation radius, pixels
    # ImageNet-style per-channel normalization (unit scale for the
    # synthetic task, whose pixels are already ~N(0, 1))
    mean: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    std: Tuple[float, float, float] = (1.0, 1.0, 1.0)


@dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    input: Optional[InputConfig] = None  # None = seed-era raw feed
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    steps_per_epoch: int = 40  # ImageNet@32k: 1.28M/32768 = 40 (paper)
    seed: int = 0
    label_smoothing: float = 0.0
    # GSPMD-path grad-norm logging costs a full extra tree reduction per
    # step, so it is opt-in; the explicit bucketed/overlapped sync paths
    # get the norm for free from the packed stream (DESIGN.md §8)
    log_grad_norm: bool = False


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[arch_id] = fn
        return fn

    return deco


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[arch_id]()


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant: same family/topology, tiny dims."""
    changes: Dict[str, object] = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.family != "hybrid" else 7),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
    )
    if cfg.n_experts:
        changes.update(n_experts=4, experts_per_token=min(cfg.experts_per_token, 2))
    if cfg.ssm_state:
        changes.update(ssm_state=16, ssm_head_dim=32)
    if cfg.shared_attn_every:
        changes.update(shared_attn_every=3, n_shared_attn_blocks=2)
    if cfg.slstm_every:
        changes.update(slstm_every=2)
    if cfg.n_encoder_layers:
        changes.update(n_encoder_layers=2)
    if cfg.family == "conv":
        changes = dict(conv_stages=(1, 1), conv_width=16, num_classes=10,
                       image_size=32, n_layers=2, d_model=0, n_heads=0,
                       n_kv_heads=0, head_dim=0, d_ff=0, vocab_size=0)
    if cfg.vision is not None:
        changes["vision"] = VisionFrontend(num_patches=16, patch_dim=64)
    if cfg.audio is not None:
        changes["audio"] = AudioFrontend(num_frames=32, frame_dim=16)
    if cfg.sliding_window:
        changes["sliding_window"] = 64
    return dataclasses.replace(cfg, **changes)
