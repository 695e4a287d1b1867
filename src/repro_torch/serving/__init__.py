"""Serving on the port: the continuous-batching engine, plus the
concurrent compile-and-run service over ``omp.compile``."""
from repro_torch.serving.compile_service import (  # noqa: F401
    CompileService,
    ServiceStats,
)
from repro_torch.serving.engine import Request, ServeEngine  # noqa: F401
