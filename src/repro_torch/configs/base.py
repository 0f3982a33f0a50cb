"""Config system: dataclasses + registry for architectures and shapes.

The PyTorch port's own copy of the JAX package's config dataclasses,
field for field, so a configuration means the same thing in both
packages. Every architecture is a ``ModelConfig`` produced by a factory
in ``src/repro_torch/configs/<arch>.py`` and registered under its public
id (``--arch <id>``); the port registers each of the JAX package's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

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

    # ---- derived quantities -------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def is_moe_layer(self, layer_idx: int) -> bool:
        if not self.n_experts:
            return False
        return layer_idx % self.moe_layer_every == self.moe_layer_every - 1

    @property
    def n_moe_layers(self) -> int:
        return sum(self.is_moe_layer(i) for i in range(self.n_layers))

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        if self.family == "conv":
            return _resnet_param_count(self)
        d, h = self.d_model, self.head_dim
        n_emb = self.vocab_size * d
        n_head = 0 if self.tie_embeddings else self.vocab_size * d
        per_attn = d * self.n_heads * h + 2 * d * self.n_kv_heads * h \
            + self.n_heads * h * d
        if self.qkv_bias:
            per_attn += (self.n_heads + 2 * self.n_kv_heads) * h
        mlp_mats = 3 if self.mlp_variant == "swiglu" else 2
        per_dense_mlp = mlp_mats * d * self.d_ff
        blocks = 0
        if self.family == "ssm":  # xLSTM
            blocks = self.n_layers * _xlstm_block_params(self)
        elif self.family == "hybrid":
            blocks = self.n_layers * _mamba2_block_params(self)
            shared = per_attn + per_dense_mlp + 2 * d
            blocks += self.n_shared_attn_blocks * shared
            # projections from concat(residual, hidden) into shared block
            blocks += self.n_shared_attn_blocks * (2 * d) * d
        else:
            for i in range(self.n_layers):
                blocks += per_attn + 2 * d  # attn + 2 norms
                if self.is_moe_layer(i):
                    blocks += self.n_experts * mlp_mats * d * self.d_ff
                    blocks += d * self.n_experts  # router
                    blocks += self.n_shared_experts * mlp_mats * d * self.d_ff
                else:
                    blocks += per_dense_mlp
        if self.n_encoder_layers:
            enc = self.n_encoder_layers * (per_attn + per_dense_mlp + 2 * d)
            dec_cross = self.n_layers * (per_attn + d)  # cross-attn + norm
            blocks += enc + dec_cross
        return n_emb + n_head + blocks + d  # final norm

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if not self.n_experts:
            return self.param_count()
        total = self.param_count()
        inactive_per_layer = (
            (self.n_experts - self.experts_per_token) * 3 * self.d_model * self.d_ff
        )
        return total - self.n_moe_layers * inactive_per_layer


def _xlstm_block_params(cfg: ModelConfig) -> int:
    """Average block size over the mLSTM/sLSTM mix (block-diag projections)."""
    d, n_h = cfg.d_model, cfg.n_heads
    d_in = int(d * cfg.mlstm_proj_factor)
    # mLSTM: up (h+gate), block-diagonal per-head qkv, i/f scalar gates, down
    mlstm = d * 2 * d_in + 3 * d_in * d_in // n_h + d_in * 2 * n_h + d_in * d + 2 * d
    # sLSTM: 4 gates input + 4 recurrent (block-diag) + gated FFN
    d_ffn = int(d * cfg.slstm_proj_factor)
    slstm = 8 * d * d // n_h + 3 * d * d_ffn + 2 * d
    if not cfg.slstm_every:
        return mlstm
    frac_s = 1.0 / cfg.slstm_every
    return int(mlstm * (1 - frac_s) + slstm * frac_s)


def _mamba2_block_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    n_h = d_in // cfg.ssm_head_dim
    in_proj = d * (2 * d_in + 2 * cfg.ssm_state + n_h)
    conv = cfg.ssm_conv_width * (d_in + 2 * cfg.ssm_state)
    out = d_in * d
    return in_proj + conv + out + 2 * n_h + d_in + 2 * d


def _resnet_param_count(cfg: ModelConfig) -> int:
    w = cfg.conv_width
    total = 3 * 7 * 7 * w + 2 * w  # stem
    c_in = w
    for stage, blocks in enumerate(cfg.conv_stages):
        mid = w * (2 ** stage)
        c_out = mid * 4
        for b in range(blocks):
            total += c_in * mid + 3 * 3 * mid * mid + mid * c_out
            total += 2 * (mid + mid + c_out)  # BN scale/offset
            if b == 0:
                total += c_in * c_out + 2 * c_out  # projection shortcut
            c_in = c_out
    total += c_in * cfg.num_classes + cfg.num_classes
    return total


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


LM_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

RESNET_SHAPES: Tuple[ShapeConfig, ...] = (
    # The paper's headline cell: 32k global minibatch.
    ShapeConfig("train_32k", 224, 32768, "train"),
    ShapeConfig("train_8k", 224, 8192, "train"),
)

# archs whose every attention layer is full/dense => long_500k is skipped
FULL_ATTENTION_SKIP = (
    "long_500k needs sub-quadratic attention; this arch is pure "
    "full-attention (see DESIGN.md section 4)"
)


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """The (arch, shape) cells of ``cfg``: the paper's two ResNet-50
    batches, or the four LM shapes with a skip reason where an arch
    cannot take ``long_500k`` (the JAX package's cells, verbatim)."""
    if cfg.family == "conv":
        return RESNET_SHAPES
    out: List[ShapeConfig] = []
    subquadratic = (
        cfg.family in ("ssm", "hybrid") or cfg.sliding_window is not None
    )
    for s in LM_SHAPES:
        if s.name == "long_500k" and not subquadratic:
            s = dataclasses.replace(s, skip_reason=FULL_ATTENTION_SKIP)
        if cfg.name == "whisper-tiny" and s.name == "long_500k":
            s = dataclasses.replace(
                s, skip_reason="enc-dec audio decoder caps at 448 positions"
            )
        out.append(s)
    return tuple(out)


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


def list_archs() -> List[str]:
    return sorted(_REGISTRY)


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
