"""starcoder2-7b — GQA, RoPE. [arXiv:2402.19173; hf]
32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18_432,
    vocab_size=49_152,
    head_dim=128,
    rope_theta=100_000.0,
    max_seq_len=16_384,
    gated_mlp=False,         # starcoder2: plain GELU MLP (c_fc/c_proj)
    qkv_bias=True,

    sub_quadratic=False,     # full attention -> long_500k skipped
)
