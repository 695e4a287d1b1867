"""Config dataclasses for models, meshes, shapes and training.

Every assigned architecture is expressed as a :class:`ModelConfig`; the
four input-shape sets of the brief are :data:`SHAPES`.  Configs are plain
frozen dataclasses — no framework magic — so the dry-run can enumerate
(arch x shape x mesh) cells cheaply.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    n_shared: int = 0             # qwen2-moe: shared experts
    shared_d_ff: int = 0          # hidden size of the shared-expert FFN
    dense_residual_d_ff: int = 0  # arctic: dense FFN residual beside the MoE
    period: int = 1               # jamba: MoE every `period` layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # pad the expert dimension to unlock EP sharding when n_experts does
    # not divide the model axis (qwen2-moe: 60 -> 64; dummies never
    # routed; ~6% weight overhead). Beyond-paper opt, EXPERIMENTS.md §Perf-E.
    n_padded: int = 0

    @property
    def e_alloc(self) -> int:
        return max(self.n_padded, self.n_experts)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (whisper). The modality frontend
    (conv over mel frames) is a STUB: input_specs() provides precomputed
    frame embeddings, per the brief."""

    n_layers: int
    n_frames: int = 1500          # whisper: 30 s of audio at 50 Hz


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | ssm | moe | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    max_seq_len: int = 131_072
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    gated_mlp: bool = True        # SwiGLU (3 mats) vs plain GELU MLP (2)
    # attention pattern ----------------------------------------------------
    sliding_window: Optional[int] = None     # SWA width (h2o-danube, local)
    local_global_period: Optional[int] = None  # gemma3: 6 => 5 local + 1 global
    attn_layer_period: Optional[int] = None    # jamba: attn every k-th layer
    # sub-modules ----------------------------------------------------------
    ssm: Optional[SSMConfig] = None
    moe: Optional[MoEConfig] = None
    encoder: Optional[EncoderConfig] = None
    # modality stub: inputs are precomputed embeddings, not token ids
    embedding_stub: bool = False
    # whether full attention makes long_500k infeasible (DESIGN.md §4)
    sub_quadratic: bool = False

    # ----- derived -------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(1, self.n_kv_heads)

    def layer_kind(self, layer_idx: int) -> str:
        """Block type of layer ``layer_idx`` (the interleave patterns)."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid" and self.attn_layer_period:
            # jamba: 1 attention layer per `attn_layer_period` (the rest SSM)
            return ("attn" if layer_idx % self.attn_layer_period
                    == self.attn_layer_period - 1 else "ssm")
        return "attn"

    def attn_kind(self, layer_idx: int) -> str:
        """'global' | 'local' attention flavour for attention layers."""
        if self.local_global_period:
            return ("global" if layer_idx % self.local_global_period
                    == self.local_global_period - 1 else "local")
        if self.sliding_window:
            return "local"
        return "global"

    def ffn_kind(self, layer_idx: int) -> str:
        """'dense' | 'moe' for this layer's FFN."""
        if self.moe is None:
            return "dense"
        if layer_idx % self.moe.period == self.moe.period - 1:
            return "moe"
        return "dense"

    def param_count(self) -> int:
        """Total parameters (embeddings included once)."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k + shared + dense)."""
        return _param_count(self, active_only=True)


def _ffn_params(cfg: ModelConfig, layer: int, active_only: bool) -> int:
    d = cfg.d_model
    n_mats = 3 if cfg.gated_mlp else 2
    if cfg.ffn_kind(layer) == "dense":
        return n_mats * d * cfg.d_ff
    moe = cfg.moe
    n_e = moe.top_k if active_only else moe.n_experts
    total = 3 * d * moe.d_expert * n_e
    if moe.n_shared:
        total += 3 * d * moe.shared_d_ff  # fused shared expert
    if moe.dense_residual_d_ff:
        total += 3 * d * moe.dense_residual_d_ff
    total += d * moe.n_experts  # router
    return total


def _attn_params(cfg: ModelConfig) -> int:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = d * h * hd + 2 * d * kv * hd + h * hd * d
    if cfg.qkv_bias:
        p += (h + 2 * kv) * hd
    return p


def _ssm_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    d = cfg.d_model
    din = s.d_inner(d)
    nh = s.n_heads(d)
    # in_proj: z, x, B, C, dt ; conv over (x,B,C); out_proj; A,D per head
    in_proj = d * (2 * din + 2 * s.d_state + nh)
    conv = s.d_conv * (din + 2 * s.d_state)
    out_proj = din * d
    return in_proj + conv + out_proj + 2 * nh


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    total = cfg.vocab_size * cfg.d_model  # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * cfg.d_model
    for layer in range(cfg.n_layers):
        kind = cfg.layer_kind(layer)
        if kind == "attn":
            total += _attn_params(cfg) + 2 * cfg.d_model
        else:
            total += _ssm_params(cfg) + cfg.d_model
        total += _ffn_params(cfg, layer, active_only) + cfg.d_model
    total += cfg.d_model  # final norm
    if cfg.encoder is not None:
        n_mats = 3 if cfg.gated_mlp else 2
        for _ in range(cfg.encoder.n_layers):
            total += _attn_params(cfg) + 3 * cfg.d_model
            total += n_mats * cfg.d_model * cfg.d_ff + cfg.d_model
        # decoder cross-attention blocks
        total += cfg.n_layers * (_attn_params(cfg) + cfg.d_model)
    return total


# ---------------------------------------------------------------------------
# Input shapes (the brief's four shape sets)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Mesh / run configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False

    @property
    def shape(self) -> tuple[int, ...]:
        return (2, 16, 16) if self.multi_pod else (16, 16)

    @property
    def axes(self) -> tuple[str, ...]:
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    optimizer: str = "adamw"            # "adamw" | "adafactor"
    remat: bool = True
    zero3: bool = False                 # shard params over data axis (ZeRO-3)
    grad_compression: bool = False      # int8 error-feedback DP compression
    microbatch: int = 0                 # grad accumulation (0 = off)
    strategy: str = "dp_tp"             # "dp_tp" | "dp_only" (§Perf-B)
    seq_parallel: bool = False          # Megatron-SP activations (§Perf-C)
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    seed: int = 0


def recommended_train_config(model: ModelConfig) -> TrainConfig:
    """Big models need Adafactor + ZeRO-3 + remat to fit 16 GB/chip;
    >=200B additionally store params in bf16 (T5X-style, relies on the
    factored optimizer's update clipping for stability)."""
    n = model.param_count()
    big = n > 5_000_000_000
    return TrainConfig(
        optimizer="adafactor" if big else "adamw",
        zero3=big,
        remat=True,
        param_dtype="bfloat16" if n > 200_000_000_000 else "float32",
    )
