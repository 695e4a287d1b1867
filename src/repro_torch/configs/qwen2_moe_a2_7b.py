"""qwen2-moe-a2.7b — 4 shared + 60 routed top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B] 24L d_model=2048 16H d_ff=1408(per expert)
vocab=151936."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151_936,
    head_dim=128,
    qkv_bias=True,
    max_seq_len=32_768,
    moe=MoEConfig(
        n_experts=60, top_k=4, d_expert=1408,
        n_shared=4, shared_d_ff=5632,
    ),
    sub_quadratic=False,     # full attention -> long_500k skipped
)
