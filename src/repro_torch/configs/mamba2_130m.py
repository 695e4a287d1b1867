"""mamba2-130m — SSD (state-space duality), attention-free.
[arXiv:2405.21060] 24L d_model=768 d_ff=0 vocab=50280 ssm_state=128."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=24,             # d_inner / head_dim = 1536 / 64
    n_kv_heads=24,
    d_ff=0,                 # attn-free, no separate FFN (SSD block only)
    vocab_size=50_280,
    head_dim=64,
    tie_embeddings=True,
    max_seq_len=1_048_576,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    sub_quadratic=True,
)
