"""Public facade of the PyTorch port: ``from repro_torch import omp``.

Mirrors :mod:`repro.omp`:

* ``@omp.parallel_for(stop=N, schedule=omp.dynamic(), reduction={...})``
  annotates a loop body written in PyTorch — the ``#pragma omp parallel
  for target mpi``;
* ``omp.region(loop1, omp.serial(glue), loop2, ...)`` makes a whole
  program of loops and serial glue (a ``ParallelRegion``);
* calling the program runs the *shared-memory* semantics;
* ``omp.compile(program, mesh, omp.Options(...))`` runs the pass
  pipeline (``analyze → schedule → plan → plan_comm → schedule_comm →
  lower``, plus ``kernel`` under ``lowering="kernel"``) and returns the
  distributed program as a :class:`~repro_torch.core.api.Compiled`;
* ``omp.make_mesh(shape, axis_names, device=None)`` builds the
  stacked-rank mesh — on the CUDA card unless ``device`` says otherwise
  (``repro_torch.mesh.make_process_mesh`` spreads its first axis over the
  processes of a ``torch.distributed`` group; ``omp.compile`` takes
  either);
* ``omp.to_mpi`` / ``omp.region_to_mpi`` are the reference's deprecated
  shims over ``omp.compile``;
* ``omp.enable_persistent_cache(path)`` keeps compiles across processes
  in an :class:`~repro_torch.core.aot_store.AOTStore`.
"""
from repro_torch.core.api import (  # noqa: F401
    CommMode,
    Compiled,
    CompileError,
    Lowering,
    Options,
    PassRecord,
    ShardPolicy,
    clear_compile_cache,
    compile,
    compile_cache_stats,
    disable_persistent_cache,
    enable_persistent_cache,
)
from repro_torch.core.aot_store import AOTStore  # noqa: F401
from repro_torch.core.comm import (  # noqa: F401
    ALPHA_LAUNCH_BYTES,
    BoundaryComm,
    CommCost,
    halo_exchange,
    halo_exchange2,
    modeled_cost_bytes,
    plan_boundary,
    plan_boundary2,
    plan_comm,
)
from repro_torch.core.comm_schedule import (  # noqa: F401
    CommEvent,
    CommGroup,
    CommSchedule,
    build_comm_schedule,
)
from repro_torch.core.context import (  # noqa: F401
    Affine,
    ContextInfo,
    ReadKind,
    VarClass,
    WriteKind,
    analyze_context,
)
from repro_torch.core.kernel_lower import KernelPlan, KernelSpan  # noqa: F401
from repro_torch.core.loop import LoopInfo, LoopNotCanonical, analyze_loop  # noqa: F401
from repro_torch.core.nest import LoopNest, NestAffine, ShiftedWindow  # noqa: F401
from repro_torch.core.plan import DistPlan, KAffine, make_plan  # noqa: F401
from repro_torch.core.pragma import (  # noqa: F401
    DYNAMIC,
    GUIDED,
    STATIC,
    At,
    ParallelFor,
    ParallelRegion,
    Put,
    Red,
    Schedule,
    SerialStage,
    at,
    dynamic,
    guided,
    parallel_for,
    put,
    red,
    region,
    serial,
    static,
)
from repro_torch.core.region import (  # noqa: F401
    DistributedRegion,
    RegionPlan,
    SlabLayout,
    SlabLayout2,
    plan_region,
    region_to_mpi,
)
from repro_torch.core.schedule import (  # noqa: F401
    ChunkPlan,
    guided_chunk_size,
    make_chunk_plan,
    make_nest_chunk_plans,
    paper_chunk_size,
)
from repro_torch.core.transform import (  # noqa: F401
    DistributedProgram,
    run_reference,
    to_mpi,
)
from repro_torch.mesh import Mesh, make_mesh  # noqa: F401
