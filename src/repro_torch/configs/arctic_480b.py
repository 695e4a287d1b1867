"""arctic-480b — 128 experts top-2 + dense residual.
[hf:Snowflake/snowflake-arctic-base] 35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000.

The largest memory cell: requires ZeRO-3 + Adafactor + full remat
(DESIGN.md §4)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32_000,
    head_dim=128,
    max_seq_len=4096,
    moe=MoEConfig(
        n_experts=128, top_k=2, d_expert=4864,
        dense_residual_d_ff=4864,
    ),
    sub_quadratic=False,     # full attention -> long_500k skipped
)
