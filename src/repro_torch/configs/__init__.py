"""Architecture registry: ``get_config(arch)`` / ``list_archs()``.

The ten assigned architectures plus reduced "smoke" variants of each
(same family, tiny dims) used by the CPU test-suite.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (  # noqa: F401
    EncoderConfig,
    MeshConfig,
    ModelConfig,
    MoEConfig,
    SHAPES,
    ShapeConfig,
    SSMConfig,
    TrainConfig,
    recommended_train_config,
)

from repro_torch.configs import (  # noqa: E402
    arctic_480b,
    gemma3_1b,
    h2o_danube3_4b,
    internvl2_76b,
    jamba_1_5_large_398b,
    mamba2_130m,
    qwen1_5_110b,
    qwen2_moe_a2_7b,
    starcoder2_7b,
    whisper_small,
)

_REGISTRY: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        mamba2_130m.CONFIG,
        internvl2_76b.CONFIG,
        starcoder2_7b.CONFIG,
        gemma3_1b.CONFIG,
        qwen1_5_110b.CONFIG,
        h2o_danube3_4b.CONFIG,
        whisper_small.CONFIG,
        jamba_1_5_large_398b.CONFIG,
        qwen2_moe_a2_7b.CONFIG,
        arctic_480b.CONFIG,
    ]
}


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    try:
        return _REGISTRY[arch]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch!r}; available: {', '.join(list_archs())}"
        ) from None


def smoke_config(arch: str) -> ModelConfig:
    """A reduced config of the same family for CPU smoke tests: few
    layers, narrow width, tiny vocab — structure preserved (interleave
    patterns, MoE, enc-dec), sizes shrunk."""
    cfg = get_config(arch)
    changes: dict = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(4, max(1, cfg.n_kv_heads * 4 // cfg.n_heads)),
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=32,
        max_seq_len=512,
    )
    if cfg.sliding_window:
        changes["sliding_window"] = 16
    if cfg.local_global_period:
        changes["local_global_period"] = 2
        changes["n_layers"] = 4
    if cfg.attn_layer_period:
        changes["attn_layer_period"] = 2
        changes["n_layers"] = 4
    if cfg.ssm is not None:
        changes["ssm"] = SSMConfig(
            d_state=16, d_conv=4, expand=2, head_dim=32, chunk=16)
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=min(8, cfg.moe.n_experts),
            top_k=min(2, cfg.moe.top_k),
            d_expert=64,
            shared_d_ff=64 if cfg.moe.n_shared else 0,
            n_shared=min(1, cfg.moe.n_shared),
            dense_residual_d_ff=64 if cfg.moe.dense_residual_d_ff else 0,
        )
    if cfg.encoder is not None:
        changes["encoder"] = EncoderConfig(n_layers=2, n_frames=32)
    return dataclasses.replace(cfg, name=f"{cfg.name}-smoke", **changes)
