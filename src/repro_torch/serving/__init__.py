"""Serving on the port: the continuous-batching engine."""
from repro_torch.serving.engine import Request, ServeEngine  # noqa: F401
