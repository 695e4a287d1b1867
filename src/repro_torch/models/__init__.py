"""Model stack of the port: layers, attention and SSM blocks, the MoE
FFN and the decoder LM (counterpart of :mod:`repro.models`; the
encoder-decoder model waits for a later slice).  Every parameter is paired
with a tuple of logical axis names (:mod:`repro_torch.core.tensor_plan`).
"""
from repro_torch.models.model import build_model  # noqa: F401
