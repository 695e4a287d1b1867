"""gemma3-1b — 5:1 local:global attention interleave, 128k context.
[hf:google/gemma-3-1b-pt] 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144.

Predominantly-local attention (window 512, one global layer per 6) makes
long-context decode sub-quadratic in aggregate; long_500k RUNS for this
arch (DESIGN.md §4)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab_size=262_144,
    head_dim=256,
    rope_theta=1_000_000.0,
    max_seq_len=131_072,
    tie_embeddings=True,
    sliding_window=512,
    local_global_period=6,   # 5 local : 1 global
    sub_quadratic=True,
)
