"""OMP2MPI core on PyTorch: pragma IR, analyses, planning and codegen.

Module for module the counterpart of :mod:`repro.core`:

* :mod:`repro_torch.core.api`          — ``omp.compile``, ``Options``, the
  pass pipeline and the compilation cache,
* :mod:`repro_torch.core.aot_store`    — the persistent compile store
  (entries that outlive the process, keyed by structural fingerprints),
* :mod:`repro_torch.core.pragma`       — the OpenMP annotation surface,
* :mod:`repro_torch.core.context`      — Context Analysis over the aten
  graph of the vmapped body (§3.1.1),
* :mod:`repro_torch.core.loop`         — Loop Analysis (§3.1.2),
* :mod:`repro_torch.core.nest`         — loop-nest IR and slab geometry,
* :mod:`repro_torch.core.schedule`     — chunking math (§3.1.3),
* :mod:`repro_torch.core.plan`         — Workload Distribution (§3.1.3),
* :mod:`repro_torch.core.transform`    — block executors (§3.1.3–4),
* :mod:`repro_torch.core.region`       — whole programs: the residency
  planner and the fused region executors,
* :mod:`repro_torch.core.comm`         — the cost-modeled boundary
  planner and the halo emitters,
* :mod:`repro_torch.core.comm_schedule` — the schedule_comm pass: packed
  exchanges, fused combines, hoisting,
* :mod:`repro_torch.core.kernel_lower` — ``Lowering.KERNEL``: the span
  kernel behind each block and each span of region stages,
* :mod:`repro_torch.core.reduction`    — reduction clause lowering,
* :mod:`repro_torch.core.report`       — the "generated code" view.
"""
