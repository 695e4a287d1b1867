"""whisper-small — encoder-decoder ASR backbone. [arXiv:2212.04356]
12L d_model=768 12H d_ff=3072 vocab=51865.

[audio]: the conv-over-mel frontend is a STUB — input_specs() provides
precomputed 1500-frame encoder embeddings.  Decode shapes lower the
decoder step with cross-attention KV from the encoder (max positions are
shape-parameterised so decode_32k is lowerable; the real model caps at
448 decoder positions)."""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,              # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51_865,
    head_dim=64,
    max_seq_len=32_768,
    gated_mlp=False,          # whisper: plain GELU MLP

    encoder=EncoderConfig(n_layers=12, n_frames=1500),
    embedding_stub=True,      # encoder inputs are precomputed frames
    sub_quadratic=False,      # full attention -> long_500k skipped
)
