"""internvl2-76b — InternViT + InternLM2 backbone. [arXiv:2404.16821]
80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.

VLM: the vision frontend is a STUB — input_specs() provides precomputed
patch embeddings mixed into the token stream (brief: "[vlm] entries
specify the transformer BACKBONE only")."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28_672,
    vocab_size=128_256,
    head_dim=128,
    max_seq_len=32_768,
    embedding_stub=True,     # patch embeddings arrive precomputed
    sub_quadratic=False,     # full attention -> long_500k skipped
)
