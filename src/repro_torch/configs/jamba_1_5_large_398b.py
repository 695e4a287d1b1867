"""jamba-1.5-large-398b — Mamba+attention 1:7 interleave + MoE.
[arXiv:2403.19887; hf] 72L d_model=8192 64H (GQA kv=8) d_ff=24576,
MoE 16e top-2 every other layer.

Hybrid (mostly SSM) -> long_500k RUNS."""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24_576,
    vocab_size=65_536,
    head_dim=128,
    max_seq_len=262_144,
    attn_layer_period=8,     # 1 attention : 7 mamba
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=128, chunk=256),
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24_576, period=2),
    sub_quadratic=True,
)
