"""Logical axis names of the model stack — counterpart of the vocabulary
of :mod:`repro.core.tensor_plan`.

Every parameter and cache tensor of :mod:`repro_torch.models` travels
with a tuple of these names (``init`` returns ``(params, axes)`` twin
trees, as the JAX package does).  The planner that maps them onto a mesh
is not ported yet; the names are kept so the trees stay the reference's.
"""
BATCH = "batch"
SEQ = "seq"
SEQ_KV = "seq_kv"
D_MODEL = "d_model"
HEADS = "heads"
KV_HEADS = "kv_heads"
HEAD_DIM = "head_dim"
D_FF = "d_ff"
VOCAB = "vocab"
EXPERTS = "experts"
D_EXPERT = "d_expert"
LAYERS = "layers"          # the stacked leading dim of a period's slots
D_INNER = "d_inner"        # mamba
D_STATE = "d_state"
CONV = "conv"
GROUPS = "groups"          # MoE dispatch groups
FRAMES = "frames"          # whisper encoder positions
