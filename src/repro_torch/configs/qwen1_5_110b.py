"""qwen1.5-110b — QKV bias. [hf:Qwen/Qwen1.5-110B]
80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49_152,
    vocab_size=152_064,
    head_dim=128,
    qkv_bias=True,
    max_seq_len=32_768,
    sub_quadratic=False,     # full attention -> long_500k skipped
)
