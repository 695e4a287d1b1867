"""Runtime around a compiled program and a training run: fault
injection, straggler re-weighting, elastic remesh, resilient execution
and the fault-tolerant train loop (counterpart of :mod:`repro.runtime`)."""
from repro_torch.runtime.straggler import StragglerMonitor, rebalance_chunks  # noqa: F401
from repro_torch.runtime.elastic import plan_elastic_remesh, reshard_tree  # noqa: F401
from repro_torch.runtime.fault_injection import (  # noqa: F401
    DeviceLossError, FaultPlan, FaultSpec, Injector, inject)
from repro_torch.runtime.resilient import (  # noqa: F401
    CorruptOutputError, ResilientExecutor, RetryPolicy)
from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    FaultTolerantLoop, StepFailure)
