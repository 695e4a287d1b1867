"""Model stack of the port: layers, attention blocks and the decoder LM
(counterpart of :mod:`repro.models`; the SSM and MoE modules and the
encoder-decoder model wait for later slices).  Every parameter is paired
with a tuple of logical axis names (:mod:`repro_torch.core.tensor_plan`).
"""
from repro_torch.models.model import build_model  # noqa: F401
