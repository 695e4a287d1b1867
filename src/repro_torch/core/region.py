"""Whole-program OMP→MPI transformation with inter-loop residency
planning — counterpart of :mod:`repro.core.region`.

OMP2MPI transforms each ``parallel for`` in isolation: every block stages
its IN buffers out of rank 0's shared memory and returns every OUT slab
back to it (paper Fig. 1b).  For a *chain* of blocks that means a
gather→rebroadcast round trip between consecutive loops even when the
next loop immediately re-distributes the same array the same way.  This
module transforms a :class:`~repro_torch.core.pragma.ParallelRegion` as a
whole:

* :func:`plan_region` — the **inter-loop residency planner**.  It walks
  the stages, tracking the layout of every environment buffer
  (replicated or chunk-cyclic slab), and matches each loop's OUT layout
  against the next loop's IN requirement: compatible layouts stay
  **resident**; a stencil read of a slab becomes a **halo** exchange of
  neighbor rows; anything else is materialised by one ``all_gather``.
  Each slab boundary is lowered through the cost-modeled planner
  (:mod:`repro_torch.core.comm`) and recorded as a
  :class:`~repro_torch.core.comm.BoundaryComm`.  Serial glue runs on
  replicated buffers; its output shapes are traced on the ``meta``
  device (the reference uses ``jax.eval_shape``).

* :class:`DistributedRegion` — the executor built by
  :func:`repro_torch.core.api.compile`.  ``Lowering.FUSED`` runs the
  whole region as one program on the stacked-rank mesh
  (:func:`_execute_region` / :func:`_execute_region2`): resident slabs
  stay in their chunk-cyclic layout ``(n_loc, P, c, *rest)`` from one
  loop to the next, halo windows come from ring ``ppermute`` shifts
  (packed and hoisted to the producer under the ``aggregate`` comm
  schedule), and only the exit reassembles the shared-memory layout.
  ``Lowering.KERNEL`` is the same executor with each exchange-free span
  of stages run as ONE span-kernel launch
  (:mod:`repro_torch.core.kernel_lower`).  ``Lowering.COLLECTIVE`` keeps
  the paper's per-loop staging (:meth:`DistributedRegion._run_staged`)
  as the baseline.  On a :class:`~repro_torch.mesh.ProcessMesh` a
  process's resident slabs and halo windows hold its own ranks
  (``(n_loc, block, c, *rest)``), a reshard gathers across processes
  (the counted ``all_gather``, whose result it uses), serial glue runs on
  every process on the same replicated values, and the exit joins the
  slabs uncounted (:meth:`~repro_torch.mesh.Mesh.join`).

Residency compatibility: loop A's write slab holds row ``base + j*c + r``
at (chunk ``j``, lane ``r``); loop B consumes it in place iff both loops
share the chunk geometry ``(c, P, n_loc, padded)``, cover the same trip
count, and B's per-iteration read map equals A's write map.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from repro_torch import convert
from repro_torch.core import comm as comm_mod
from repro_torch.core import comm_schedule as cs_mod
from repro_torch.core import nest as nest_mod
from repro_torch.core import pragma, reduction as red_mod
from repro_torch.core import transform as tf
from repro_torch.core.comm import (  # noqa: F401 (re-export)
    BoundaryComm,
    SlabLayout,
    SlabLayout2,
)
from repro_torch.core.context import TensorSpec, spec_of
from repro_torch.core.loop import LoopNotCanonical
from repro_torch.core.plan import DistPlan, make_plan

REPLICATED = "repl"

_SLABS = (SlabLayout, SlabLayout2)


@dataclasses.dataclass
class StageExec:
    """One stage of the fused execution schedule."""

    name: str
    kind: str                          # "loop" | "serial"
    stage: Any                         # ParallelFor | SerialStage
    plan: DistPlan | None
    gathers: tuple[str, ...]           # keys resharded (materialised) first
    feeds: dict[str, str]              # sharded-in key -> resident|halo|slice
    serial_writes: tuple[str, ...] = ()


@dataclasses.dataclass
class RegionPlan:
    """Output of the inter-loop residency planner."""

    name: str
    axis: str
    num_devices: int
    stages: list[StageExec]
    env_keys: list[str]                # region input keys
    touched_keys: list[str]            # keys (re)written by some stage
    final_layout: dict[str, Any]       # touched key -> REPLICATED | slab
    n_elided: int                      # resident handoffs (round trips saved)
    n_reshards: int                    # minimal collectives inserted
    log: list[str]                     # human-readable transition journal
    comms: list[BoundaryComm] = dataclasses.field(default_factory=list)
    n_halo: int = 0                    # boundaries lowered to ppermute shifts
    comm_mode: str = "auto"
    rank: int = 1                      # nest rank shared by every loop
    # the schedule_comm artifact (comm_schedule.CommSchedule), attached
    # after planning by the compile pipeline (or lazily by the executor)
    comm_sched: Any = None

    @property
    def loop_plans(self) -> list[DistPlan]:
        return [s.plan for s in self.stages if s.plan is not None]

    @property
    def planned_wire_bytes(self) -> int:
        """Modeled wire bytes of the chosen boundary ops."""
        return sum(bc.cost.wire_bytes for bc in self.comms)

    @property
    def gather_wire_bytes(self) -> int:
        """Modeled wire bytes under the gather rule (residency kept,
        every non-resident boundary lowered to the gather)."""
        total = 0
        for bc in self.comms:
            if bc.op == comm_mod.RESIDENT:
                continue
            alts = [c for op, c in bc.alternatives.items()
                    if op in (comm_mod.ALL_GATHER, comm_mod.REPLICATE)]
            total += alts[0].wire_bytes if alts else bc.cost.wire_bytes
        return total


# ---------------------------------------------------------------------------
# The residency planner
# ---------------------------------------------------------------------------


def serial_out_specs(stage: pragma.SerialStage,
                     env_shapes: Mapping[str, TensorSpec]) -> dict:
    """Shapes/dtypes of a serial stage's updates, traced on the ``meta``
    device (no data, no card): the port's ``jax.eval_shape``.  Glue that
    leaves the device (numpy conversion, I/O) raises here."""
    env = {k: torch.empty(s.shape, dtype=s.dtype, device="meta")
           for k, s in env_shapes.items()}
    out = stage.fn(env)
    if not isinstance(out, dict):
        raise LoopNotCanonical(
            f"serial stage {stage.name!r} must return a dict of "
            "whole-array updates")
    return {k: spec_of(v) for k, v in out.items()}


def _fresh_spec(plan, key) -> TensorSpec:
    info = plan.context.vars[key]
    return TensorSpec(tuple(info.write.value_shape), info.write.value_dtype)


def _boundary_replicated(stage_name, key, st, aval, comm, chunks=None):
    """Plan a forced-replication boundary for either slab rank."""
    if isinstance(st, SlabLayout2):
        return comm_mod.plan_boundary2(
            stage=stage_name, key=key, layout=st, chunks_axes=None,
            trips=(0, 0), aval=aval, in_strategy="none", halo_axes=None,
            shard_ndim=0, needs_replicated=True, mode=comm)
    return comm_mod.plan_boundary(
        stage=stage_name, key=key, layout=st, chunks=chunks, trip=0,
        aval=aval, in_strategy="none", halo=None, needs_replicated=True,
        mode=comm)


def plan_region(
    region: pragma.ParallelRegion,
    env: Mapping[str, Any],
    num_devices: int | tuple,
    *,
    axis: str | tuple = "data",
    comm: str = "auto",
    schedule: pragma.Schedule | None = None,
    device=None,
) -> RegionPlan:
    """Match each loop's OUT layout against the next loop's IN needs,
    lowering each slab boundary through the cost-modeled planner
    (``comm="auto"``; ``comm="gather"`` pins the all-gather baseline).
    Rank-2 regions (every loop ``collapse=2``) plan over a 2-D mesh:
    ``axis`` and ``num_devices`` are then 2-tuples.  ``env`` holds
    tensors or :class:`~repro_torch.core.context.TensorSpec`\\ s;
    ``device`` is where bodies are traced (default: the env's)."""
    if comm not in comm_mod.COMM_MODES:
        raise ValueError(
            f"unknown comm mode {comm!r}; expected {comm_mod.COMM_MODES}")
    rank = region.rank
    if (rank == 2) != isinstance(axis, tuple):
        raise LoopNotCanonical(
            f"region rank {rank} does not match mesh axis clause {axis!r} "
            "(collapse=2 regions need a 2-tuple of mesh axes)")
    if device is None:
        device = next((v.device for v in env.values()
                       if isinstance(v, torch.Tensor)), torch.device("cpu"))
    env_shapes = {k: spec_of(v) for k, v in env.items()}
    state: dict[str, Any] = {k: REPLICATED for k in env_shapes}
    touched: set[str] = set()
    stages: list[StageExec] = []
    n_elided = n_reshards = n_halo = 0
    log: list[str] = []
    comms: list[BoundaryComm] = []

    for stage in region.stages:
        if isinstance(stage, pragma.SerialStage):
            reads = (stage.reads if stage.reads is not None
                     else tuple(env_shapes))
            gathers = tuple(
                k for k in reads if isinstance(state.get(k), _SLABS))
            out_sh = serial_out_specs(stage, env_shapes)
            for k in gathers:
                n_reshards += 1
                comms.append(_boundary_replicated(
                    stage.name, k, state[k], env_shapes[k], comm))
                log.append(f"{stage.name}: reshard {k!r} "
                           f"(~{comm_mod.full_bytes(env_shapes[k])} B "
                           "all-gather; serial glue reads it)")
                state[k] = REPLICATED
            for k, v in out_sh.items():
                env_shapes[k] = v
                state[k] = REPLICATED
                touched.add(k)
            stages.append(StageExec(
                name=stage.name, kind="serial", stage=stage, plan=None,
                gathers=gathers, feeds={}, serial_writes=tuple(out_sh)))
            continue

        plan = make_plan(stage, env_shapes, num_devices, axis=axis,
                         lowering="collective", shard_inputs=True,
                         schedule=schedule, device=device)
        t = plan.nest.total_trip
        if t == 0:
            # zero-trip loop: the executor only folds reduction
            # identities; no other buffer moves, so no layout changes
            gathers0: list[str] = []
            for key, dec in plan.vars.items():
                if dec.out_strategy != "reduce":
                    continue
                if isinstance(state.get(key), _SLABS):
                    gathers0.append(key)
                    n_reshards += 1
                    comms.append(_boundary_replicated(
                        stage.name, key, state[key], env_shapes[key], comm,
                        chunks=plan.chunks))
                    log.append(
                        f"{stage.name}: reshard {key!r} "
                        f"(~{comm_mod.full_bytes(env_shapes[key])} B "
                        "all-gather; zero-trip reduction folds the prior "
                        "value)")
                state[key] = REPLICATED
                touched.add(key)
                if key not in env_shapes:
                    env_shapes[key] = _fresh_spec(plan, key)
            stages.append(StageExec(
                name=stage.name, kind="loop", stage=stage, plan=plan,
                gathers=tuple(gathers0), feeds={}))
            continue
        if plan.rank == 2:
            se, n_e, n_h, n_r = _plan_loop_stage2(
                stage, plan, state, touched, env_shapes, comms, log, comm)
            n_elided += n_e
            n_halo += n_h
            n_reshards += n_r
            stages.append(se)
            continue
        gathers: list[str] = []
        feeds: dict[str, str] = {}
        for key, dec in plan.vars.items():
            st = state.get(key, REPLICATED)
            is_slab = isinstance(st, SlabLayout)
            write_b = dec.write_map.b if dec.write_map is not None else None

            # out-merges that consume the pre-stage value need it
            # replicated — except a partial write replacing a slab of the
            # identical interval, whose prior chains through
            interval_same = (is_slab and dec.out_strategy == "partial"
                             and st.base == write_b and st.cover == t)
            prior_repl = (
                dec.out_strategy == "scatter"
                or (dec.out_strategy == "partial" and not interval_same)
                or (dec.out_strategy == "reduce" and key in state)
            )

            consumes = dec.in_strategy in ("shard", "shard_halo", "replicate")
            if is_slab and (prior_repl or consumes):
                bc = comm_mod.plan_boundary(
                    stage=stage.name, key=key, layout=st, chunks=plan.chunks,
                    trip=t, aval=env_shapes[key],
                    in_strategy=dec.in_strategy, halo=dec.halo,
                    needs_replicated=(prior_repl
                                      or dec.in_strategy == "replicate"),
                    mode=comm)
                comms.append(bc)
                if bc.op == comm_mod.RESIDENT:
                    feeds[key] = "resident"
                    n_elided += 1
                    log.append(
                        f"{stage.name}: {key!r} stays RESIDENT (elides "
                        f"~{2 * comm_mod.full_bytes(env_shapes[key])} B "
                        "gather+redistribute round trip)")
                elif bc.op == comm_mod.HALO:
                    feeds[key] = "halo"
                    n_halo += 1
                    g = bc.alternatives[comm_mod.ALL_GATHER].wire_bytes
                    log.append(
                        f"{stage.name}: {key!r} HALO-EXCHANGED "
                        f"(shift {bc.shift}, {bc.cost.hops} ppermute hop(s), "
                        f"~{bc.cost.wire_bytes} B on the wire vs ~{g} B "
                        "all-gather)")
                else:
                    gathers.append(key)
                    n_reshards += 1
                    state[key] = REPLICATED
                    log.append(
                        f"{stage.name}: reshard {key!r} "
                        f"(~{comm_mod.full_bytes(env_shapes[key])} B "
                        f"all-gather; {bc.reason})")
                    if dec.in_strategy in ("shard", "shard_halo"):
                        feeds[key] = "slice"
            elif dec.in_strategy in ("shard", "shard_halo"):
                feeds[key] = "slice"

            if dec.out_strategy == "identity":
                state[key] = SlabLayout.of(plan, base=0, has_prior=False)
                touched.add(key)
            elif dec.out_strategy == "partial":
                state[key] = SlabLayout.of(plan, base=write_b, has_prior=True)
                touched.add(key)
            elif dec.out_strategy in ("scatter", "put", "reduce"):
                state[key] = REPLICATED
                touched.add(key)
                if key not in env_shapes:     # fresh reduction output
                    env_shapes[key] = _fresh_spec(plan, key)

        stages.append(StageExec(
            name=stage.name, kind="loop", stage=stage, plan=plan,
            gathers=tuple(gathers), feeds=feeds))

    final_layout = {k: state[k] for k in sorted(touched)}
    return RegionPlan(
        name=region.name, axis=axis, num_devices=num_devices,
        stages=stages, env_keys=list(env.keys()),
        touched_keys=sorted(touched), final_layout=final_layout,
        n_elided=n_elided, n_reshards=n_reshards, log=log,
        comms=comms, n_halo=n_halo, comm_mode=comm, rank=rank,
    )


def _plan_loop_stage2(stage, plan, state, touched, env_shapes, comms, log,
                      comm):
    """Residency planning for one rank-2 loop stage: the 2-D analogue of
    the rank-1 key loop in :func:`plan_region` (per-axis bases/covers,
    boundaries through :func:`repro_torch.core.comm.plan_boundary2`)."""
    trips = plan.nest.trip_counts
    n_elided = n_halo = n_reshards = 0
    gathers: list[str] = []
    feeds: dict[str, str] = {}
    for key, dec in plan.vars.items():
        st = state.get(key, REPLICATED)
        is_slab = isinstance(st, SlabLayout2)
        write_bases = (tuple(m.b for m in dec.write_maps)
                       if dec.write_maps is not None else None)

        interval_same = (is_slab and dec.out_strategy == "partial"
                         and st.bases == write_bases and st.covers == trips)
        prior_repl = (
            (dec.out_strategy == "partial" and not interval_same)
            or (dec.out_strategy == "reduce" and key in state)
        )

        consumes = dec.in_strategy in ("shard_halo", "replicate")
        if is_slab and (prior_repl or consumes):
            bc = comm_mod.plan_boundary2(
                stage=stage.name, key=key, layout=st,
                chunks_axes=plan.chunks_axes, trips=trips,
                aval=env_shapes[key], in_strategy=dec.in_strategy,
                halo_axes=dec.halo_axes, shard_ndim=dec.shard_ndim,
                needs_replicated=(prior_repl
                                  or dec.in_strategy == "replicate"),
                mode=comm)
            comms.append(bc)
            if bc.op == comm_mod.RESIDENT:
                feeds[key] = "resident"
                n_elided += 1
                log.append(
                    f"{stage.name}: {key!r} stays RESIDENT (elides "
                    f"~{2 * comm_mod.full_bytes(env_shapes[key])} B "
                    "gather+redistribute round trip)")
            elif bc.op == comm_mod.HALO:
                feeds[key] = "halo"
                n_halo += 1
                g = bc.alternatives[comm_mod.ALL_GATHER].wire_bytes
                log.append(
                    f"{stage.name}: {key!r} HALO-EXCHANGED 2-D "
                    f"(shifts {bc.shift}, {bc.cost.hops} ppermute hop(s), "
                    f"~{bc.cost.wire_bytes} B on the wire vs ~{g} B "
                    "all-gather)")
            else:
                gathers.append(key)
                n_reshards += 1
                state[key] = REPLICATED
                log.append(
                    f"{stage.name}: reshard {key!r} "
                    f"(~{comm_mod.full_bytes(env_shapes[key])} B "
                    f"all-gather; {bc.reason})")
                if dec.in_strategy == "shard_halo":
                    feeds[key] = "slice"
        elif dec.in_strategy == "shard_halo":
            feeds[key] = "slice"

        if dec.out_strategy == "identity":
            state[key] = SlabLayout2.of(plan, bases=(0, 0), has_prior=False)
            touched.add(key)
        elif dec.out_strategy == "partial":
            state[key] = SlabLayout2.of(plan, bases=write_bases,
                                        has_prior=True)
            touched.add(key)
        elif dec.out_strategy == "reduce":
            state[key] = REPLICATED
            touched.add(key)
            if key not in env_shapes:     # fresh reduction output
                env_shapes[key] = _fresh_spec(plan, key)

    se = StageExec(name=stage.name, kind="loop", stage=stage, plan=plan,
                   gathers=tuple(gathers), feeds=feeds)
    return se, n_elided, n_halo, n_reshards


# ---------------------------------------------------------------------------
# Distributed region program
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DistributedRegion:
    """The generated whole-program "MPI" code for a parallel region."""

    region: pragma.ParallelRegion
    mesh: Any
    plan: RegionPlan | None
    axis: Any = "data"
    fuse: bool = True
    shard_inputs: bool = False          # staged path only
    comm: str = "auto"                  # boundary planner mode
    comm_schedule: str = "aggregate"    # schedule_comm mode
    schedule_override: pragma.Schedule | None = None
    stage_plans: tuple | None = None    # staged path: per-loop (name, plan)
    lowering: str = "collective"        # staged path: or "master_worker"
    paper_master_excluded: bool | None = None   # staged master/worker
    use_kernel: bool = False            # Lowering.KERNEL: span kernels
    kernel_plan: Any = None             # its KernelPlan
    chunk_weights: tuple | None = None  # straggler-weighted (staged only)

    def __call__(self, env: Mapping[str, Any]) -> dict[str, Any]:
        env = tf.check_env(env, self.mesh.device)
        if not self.fuse:
            return self._run_staged(env)
        if self.plan is None:
            _, num = tf.resolve_axes(self.region, self.mesh, self.axis)
            self.plan = plan_region(
                self.region, env, num, axis=self.axis, comm=self.comm,
                schedule=self.schedule_override, device=self.mesh.device)
        if self.plan.comm_sched is None:
            self.plan.comm_sched = cs_mod.build_comm_schedule(
                self.plan, mode=self.comm_schedule)
        if self.plan.rank == 2:
            return _execute_region2(self, env)
        return _execute_region(self, env)

    def _run_staged(self, env: dict) -> dict:
        """Paper-faithful baseline: each loop transformed in isolation
        (data returns to the replicated form between stages).  When the
        compile pipeline pre-planned the stages (``stage_plans``), those
        plans execute; otherwise each loop plans on the env it sees."""
        out = dict(env)
        plans = iter(self.stage_plans) if self.stage_plans is not None \
            else None
        device = self.mesh.device
        for stage in self.region.stages:
            if isinstance(stage, pragma.SerialStage):
                out = {k: convert.to_tensor(v, device)
                       for k, v in stage(out).items()}
                continue
            if plans is not None:
                _, plan = next(plans)
            else:
                _, num = tf.resolve_axes(stage, self.mesh, self.axis)
                plan = make_plan(
                    stage, out, num, axis=self.axis, lowering=self.lowering,
                    shard_inputs=self.shard_inputs,
                    paper_master_excluded=self.paper_master_excluded,
                    schedule=self.schedule_override,
                    weights=self.chunk_weights, device=device)
            out = tf.DistributedProgram(
                program=stage, mesh=self.mesh, plan=plan,
                comm_schedule=self.comm_schedule)(out)
        return out

    def report(self) -> str:
        from repro_torch.core import report as report_mod

        if self.plan is None:
            raise ValueError(
                "call the region (or compile with env_like=) to build the "
                "residency plan before asking for a report")
        return report_mod.render_region(self.plan)


def region_to_mpi(
    region: pragma.ParallelRegion,
    mesh,
    *,
    axis: str | tuple | None = None,
    lowering: str = "collective",
    fuse: bool = True,
    shard_inputs: bool = False,
    unroll_chunks: bool = False,
    env_like: Mapping[str, Any] | None = None,
    paper_master_excluded: bool | None = None,
    comm: str = "auto",
):
    """Deprecated: use ``omp.compile(region, mesh, omp.Options(...))``.

    Thin shim: translates the legacy kwargs to
    :class:`~repro_torch.core.api.Options` — ``fuse=True`` +
    ``lowering="collective"`` becomes ``Lowering.FUSED``,
    ``fuse=False`` becomes ``Lowering.COLLECTIVE`` — and returns the
    :class:`~repro_torch.core.api.Compiled` artifact (callable like the
    ``DistributedRegion`` it used to return, with ``.plan`` /
    ``.report()`` intact).
    """
    import warnings

    from repro_torch.core import api

    warnings.warn(
        "omp.region_to_mpi() is deprecated; use omp.compile(region, mesh, "
        "omp.Options(lowering=..., comm=...)) instead",
        DeprecationWarning, stacklevel=2)
    if isinstance(region, pragma.ParallelFor):
        region = pragma.ParallelRegion((region,))
    if lowering == "master_worker":
        low = api.Lowering.MASTER_WORKER
    elif lowering != "collective":
        raise api.CompileError(f"unknown lowering {lowering!r}")
    elif fuse:
        low = api.Lowering.FUSED
    else:
        low = api.Lowering.COLLECTIVE
    options = api.Options(
        axis=axis,
        lowering=low,
        comm=comm,
        shard=(api.ShardPolicy.SLICE if shard_inputs
               else api.ShardPolicy.REPLICATE),
        unroll_chunks=unroll_chunks,
        paper_master_excluded=paper_master_excluded,
    )
    return api.compile(region, mesh, options, env_like=env_like)


# ---------------------------------------------------------------------------
# Fused execution (the whole region as one program on the mesh)
# ---------------------------------------------------------------------------


def _span_stages(dr, si, env_in, slab_stacks, st, feed_window, window):
    """The kernel-side feeds of every stage of the span starting at
    stage ``si``: later stages' external feeds come from the current
    ``st`` (spans never cross an exchange, so those entries are stable
    until each stage's merge runs); keys an earlier span stage wrote are
    forwarded tile to tile inside the kernel."""
    from repro_torch.core import kernel_lower as kl

    rp = dr.plan
    span = dr.kernel_plan.span_at(si)
    specs = []
    written: set = set()
    for sj in span.stage_indices:
        sse = rp.stages[sj]
        sp_plan = sse.plan
        if sj == si:
            ext, repl, fwd = dict(slab_stacks), dict(env_in), set()
        else:
            ext, repl, fwd = {}, {}, set()
            for key in sp_plan.context.env_keys:
                dec = sp_plan.vars[key]
                if dec.in_strategy in ("shard", "shard_halo"):
                    if sse.feeds[key] != "resident":      # "slice"
                        ext[key] = feed_window(sse, key, dec)
                    elif key in written:
                        fwd.add(key)            # on-chip hand-off
                    else:
                        ext[key] = st[key][1]
                elif dec.in_strategy == "replicate":
                    repl[key] = st[key][1]
        specs.append(kl.SpanStage(plan=sp_plan, program=sse.stage,
                                  ext_windows=ext, env_repl=repl,
                                  forwarded=frozenset(fwd)))
        written |= kl.written_key_set(sp_plan)
    results = kl.execute_span(specs, span, dr.mesh.device, window)
    return dict(zip(span.stage_indices, results))


def _reduction_identity(plan, key, device):
    rop = red_mod.get_reduction(plan.vars[key].reduction_op)
    w = plan.context.vars[key].write
    return rop, torch.full(w.value_shape,
                           red_mod.identity_value(rop, w.value_dtype),
                           dtype=w.value_dtype, device=device)


def _execute_region(dr: DistributedRegion, env: dict) -> dict:
    tf._maybe_fault("region")
    rp = dr.plan
    mesh, axis = dr.mesh, rp.axis
    device = mesh.device
    sched = rp.comm_sched
    aggregate = sched is not None and sched.mode == "aggregate"
    if not rp.touched_keys:
        return dict(env)
    window = nest_mod.rank_window(mesh, axis)

    # per key: ("repl", tensor) or ("slab", stacks (n_loc, P, c, *rest) —
    # block ranks of P on a process mesh —, base, cover, prior, dtype)
    st: dict[str, tuple] = {k: ("repl", v) for k, v in env.items()}
    prefetched: dict[tuple[int, str], Any] = {}
    span_results: dict[int, tuple] = {}

    def issue_prefetch(after_idx):
        for grp in sched.groups_after(after_idx):
            items = []
            for ev in grp.events:
                _, stacks, sbase, scover, sprior, sdtype = st[ev.key]
                items.append(cs_mod.HaloItem(
                    stacks=stacks, chunks=ev.chunks, shifts=ev.shifts,
                    prior=sprior, bases=(sbase,), covers=(scover,),
                    dtype=sdtype))
            wins = cs_mod.aggregated_halo_exchange(
                mesh, items, axis=axis,
                num_devices=grp.events[0].num_devices[0])
            for ev, win in zip(grp.events, wins):
                prefetched[(ev.consumer_idx, ev.key)] = win

    def materialize(key):
        if st[key][0] == "repl":
            return st[key][1]
        _, stacks, base, cover, prior, dtype = st[key]
        stacks = mesh.all_gather(stacks.movedim(1, 0), axis).movedim(0, 1)
        flat = stacks.reshape((-1,) + tuple(stacks.shape[3:]))[:cover]
        flat = flat.to(dtype)
        if prior is None:
            full = flat
        else:
            full = prior.clone()
            full[base:base + cover] = flat
        st[key] = ("repl", full)
        return full

    def slice_window(se, key, dec):
        halo = dec.halo if dec.halo is not None else (0, 0)
        return nest_mod.halo_slabs(st[key][1], se.plan.chunks, halo, window)

    for si, se in enumerate(rp.stages):
        for k in se.gathers:
            materialize(k)

        if se.kind == "serial":
            env_full = {k: e[1] for k, e in st.items() if e[0] == "repl"}
            for k, v in se.stage.fn(env_full).items():
                st[k] = ("repl", convert.to_tensor(v, device))
            continue

        plan = se.plan
        t = plan.loop.trip_count
        if t == 0:
            for key, dec in plan.vars.items():
                if dec.out_strategy == "reduce":
                    rop, val = _reduction_identity(plan, key, device)
                    if key in st:
                        val = rop.pairwise(materialize(key), val)
                    st[key] = ("repl", val)
            continue

        env_in: dict[str, Any] = {}
        slab_stacks: dict[str, Any] = {}
        for key in plan.context.env_keys:
            dec = plan.vars[key]
            if dec.in_strategy in ("shard", "shard_halo"):
                feed = se.feeds[key]
                if feed == "resident":
                    slab_stacks[key] = st[key][1]
                elif feed == "halo":
                    if aggregate:
                        # issued right after its producer (the prefetch)
                        slab_stacks[key] = prefetched.pop((si, key))
                    else:
                        _, stacks, sbase, scover, sprior, sdtype = st[key]
                        h = dec.halo if dec.halo is not None else (0, 0)
                        slab_stacks[key] = comm_mod.halo_exchange(
                            mesh, stacks, axis=axis,
                            num_devices=plan.chunks.num_devices,
                            chunk=plan.chunks.chunk,
                            delta_min=h[0] - sbase, delta_max=h[1] - sbase,
                            prior=sprior, base=sbase, cover=scover,
                            dtype=sdtype)
                else:
                    slab_stacks[key] = slice_window(se, key, dec)
            elif dec.in_strategy == "replicate":
                env_in[key] = st[key][1]

        if dr.use_kernel:
            if si not in span_results:
                span_results.update(_span_stages(
                    dr, si, env_in, slab_stacks, st, slice_window, window))
            carry, ys = span_results.pop(si)
        else:
            carry, ys = tf._run_local_chunks(plan, se.stage, env_in,
                                             slab_stacks, device, window)

        # cross-device combines of this stage's merges: per key inline,
        # or one fused collective per (collective, dtype) group
        pending: dict[tuple[str, str], tuple[str, Any]] = {}
        d = mesh.axis_index(axis)
        for key, dec in plan.vars.items():
            info = plan.context.vars[key]
            if dec.out_strategy == "identity":
                st[key] = ("slab", ys[key], 0, t, None, info.dtype)
            elif dec.out_strategy == "partial":
                b = dec.write_map.b
                prev = st.get(key)
                if (prev is not None and prev[0] == "slab"
                        and prev[2] == b and prev[3] == t):
                    prior = prev[4]     # same interval: chain the prior
                else:
                    prior = st[key][1]  # replicated (planner enforced)
                st[key] = ("slab", ys[key], b, t, prior, info.dtype)
            elif dec.out_strategy == "scatter":
                buf, mask = carry[key]
                pending[(key, "buf")] = ("psum", buf)
                pending[(key, "mask")] = ("psum", mask.to(torch.int32))
            elif dec.out_strategy == "put":
                j_star = (t - 1) // plan.chunks.chunk
                owner = j_star % plan.chunks.num_devices
                val = carry[key]
                sel = (d == owner).reshape((-1,) + (1,) * (val.dim() - 1))
                pending[(key, "put")] = ("psum", torch.where(
                    sel, val, torch.zeros_like(val)))
            elif dec.out_strategy == "reduce":
                rop = red_mod.get_reduction(dec.reduction_op)
                if rop.collective in ("psum", "pmax", "pmin"):
                    pending[(key, "red")] = (rop.collective, carry[key])
                else:
                    val = red_mod.cross_device_combine(mesh, rop, carry[key],
                                                       axis)
                    if key in st:
                        val = rop.pairwise(st[key][1], val)
                    st[key] = ("repl", val)
        if pending:
            combined = tf._combine(mesh, pending, axis, aggregate)
            for key, dec in plan.vars.items():
                if dec.out_strategy == "scatter":
                    summed = combined[(key, "buf")]
                    m = combined[(key, "mask")]
                    prior = st[key][1]
                    vmask = (m > 0).reshape((-1,) + (1,) * (summed.dim() - 1))
                    st[key] = ("repl", torch.where(
                        vmask, summed.to(prior.dtype), prior))
                elif dec.out_strategy == "put":
                    st[key] = ("repl", combined[(key, "put")])
                elif dec.out_strategy == "reduce" \
                        and (key, "red") in combined:
                    rop = red_mod.get_reduction(dec.reduction_op)
                    val = combined[(key, "red")]
                    if key in st:
                        val = rop.pairwise(st[key][1], val)
                    st[key] = ("repl", val)

        if aggregate:
            issue_prefetch(si)

    # exit: reassembly (layout, not messages)
    result = dict(env)
    for key, lay in rp.final_layout.items():
        if lay == REPLICATED:
            result[key] = st[key][1]
            continue
        _, stacks, base, cover, prior, _ = st[key]
        stacks = mesh.join(stacks, axis, 1)
        flat = stacks.reshape((-1,) + tuple(stacks.shape[3:]))[:lay.cover]
        flat = flat.to(env[key].dtype if key in env else flat.dtype)
        if lay.has_prior:
            full = prior.clone()
            full[lay.base:lay.base + lay.cover] = flat.to(full.dtype)
            result[key] = full
        else:
            result[key] = flat
    return result


def _execute_region2(dr: DistributedRegion, env: dict) -> dict:
    """Fused execution of a rank-2 region over the 2-D mesh: slabs stay
    resident as ``(n_i, P_i, c_i, n_j, P_j, c_j, *rest)`` stacks, halo
    boundaries run as row+column ``ppermute`` rings."""
    tf._maybe_fault("region2")
    rp = dr.plan
    mesh = dr.mesh
    device = mesh.device
    ax_i, ax_j = rp.axis
    axes = (ax_i, ax_j)
    sched = rp.comm_sched
    aggregate = sched is not None and sched.mode == "aggregate"
    if not rp.touched_keys:
        return dict(env)
    window = nest_mod.rank_window(mesh, axes)

    st: dict[str, tuple] = {k: ("repl", v) for k, v in env.items()}
    prefetched: dict[tuple[int, str], Any] = {}
    span_results: dict[int, tuple] = {}

    def issue_prefetch(after_idx):
        for grp in sched.groups_after(after_idx):
            items = []
            for ev in grp.events:
                _, stacks, bases, covers, sprior, sdtype = st[ev.key]
                items.append(cs_mod.HaloItem(
                    stacks=stacks, chunks=ev.chunks, shifts=ev.shifts,
                    prior=sprior, bases=bases, covers=covers, dtype=sdtype))
            wins = cs_mod.aggregated_halo_exchange2(
                mesh, items, axes=axes,
                num_devices=grp.events[0].num_devices)
            for ev, win in zip(grp.events, wins):
                prefetched[(ev.consumer_idx, ev.key)] = win

    def flat2(stacks, covers):
        s = stacks.shape
        flat = stacks.reshape((s[0] * s[1] * s[2], s[3] * s[4] * s[5])
                              + tuple(s[6:]))
        return flat[:covers[0], :covers[1]]

    def materialize(key):
        if st[key][0] == "repl":
            return st[key][1]
        _, stacks, bases, covers, prior, dtype = st[key]
        stacks = mesh.all_gather(stacks.movedim(1, 0), ax_i).movedim(0, 1)
        mesh.all_gather(stacks.movedim(4, 0), ax_j)
        flat = flat2(stacks, covers).to(dtype)
        if prior is None:
            full = flat
        else:
            full = prior.clone()
            full[bases[0]:bases[0] + covers[0],
                 bases[1]:bases[1] + covers[1]] = flat
        st[key] = ("repl", full)
        return full

    def slice_window(se, key, dec):
        halos = (dec.halo_axes if dec.halo_axes is not None
                 else ((0, 0), (0, 0)))
        x = st[key][1]
        chs = se.plan.chunks_axes
        if dec.shard_ndim == 2:
            return nest_mod.halo_slabs2(x, chs, halos, window)
        return nest_mod.halo_slabs(x, chs[0], halos[0], window)

    for si, se in enumerate(rp.stages):
        for k in se.gathers:
            materialize(k)

        if se.kind == "serial":
            env_full = {k: e[1] for k, e in st.items() if e[0] == "repl"}
            for k, v in se.stage.fn(env_full).items():
                st[k] = ("repl", convert.to_tensor(v, device))
            continue

        plan = se.plan
        ch_i, ch_j = plan.chunks_axes
        trips = plan.nest.trip_counts
        if plan.nest.total_trip == 0:
            for key, dec in plan.vars.items():
                if dec.out_strategy == "reduce":
                    rop, val = _reduction_identity(plan, key, device)
                    if key in st:
                        val = rop.pairwise(materialize(key), val)
                    st[key] = ("repl", val)
            continue

        env_in: dict[str, Any] = {}
        slab_stacks: dict[str, Any] = {}
        for key in plan.context.env_keys:
            dec = plan.vars[key]
            if dec.in_strategy == "shard_halo":
                feed = se.feeds[key]
                if feed == "resident":
                    slab_stacks[key] = st[key][1]
                elif feed == "halo":
                    if aggregate:
                        slab_stacks[key] = prefetched.pop((si, key))
                        continue
                    _, stacks, bases, covers, prior, dtype = st[key]
                    slab_stacks[key] = comm_mod.halo_exchange2(
                        mesh, stacks, axes=axes,
                        num_devices=(ch_i.num_devices, ch_j.num_devices),
                        chunks=(ch_i.chunk, ch_j.chunk),
                        deltas=tuple((h[0] - b, h[1] - b) for h, b in
                                     zip(dec.halo_axes, bases)),
                        prior=prior, bases=bases, covers=covers,
                        dtype=dtype)
                else:
                    slab_stacks[key] = slice_window(se, key, dec)
            elif dec.in_strategy == "replicate":
                env_in[key] = st[key][1]

        if dr.use_kernel:
            if si not in span_results:
                span_results.update(_span_stages(
                    dr, si, env_in, slab_stacks, st, slice_window, window))
            carry, ys = span_results.pop(si)
        else:
            carry, ys = tf._run_local_chunks2(plan, se.stage, env_in,
                                              slab_stacks, device, window)

        reduce_items: dict[str, tuple] = {}
        for key, dec in plan.vars.items():
            info = plan.context.vars[key]
            if dec.out_strategy == "identity":
                st[key] = ("slab2", ys[key], (0, 0), trips, None, info.dtype)
            elif dec.out_strategy == "partial":
                bases = tuple(m.b for m in dec.write_maps)
                prev = st.get(key)
                if (prev is not None and prev[0] == "slab2"
                        and prev[2] == bases and prev[3] == trips):
                    prior = prev[4]     # same rectangle: chain the prior
                else:
                    prior = st[key][1]  # replicated (planner enforced)
                st[key] = ("slab2", ys[key], bases, trips, prior, info.dtype)
            elif dec.out_strategy == "reduce":
                reduce_items[key] = (red_mod.get_reduction(dec.reduction_op),
                                     carry[key])
        if reduce_items:
            if aggregate:
                combined = cs_mod.fused_cross_device_combine(
                    mesh, reduce_items, axes)
            else:
                combined = {key: red_mod.cross_device_combine(
                    mesh, rop, val, axes)
                    for key, (rop, val) in reduce_items.items()}
            for key, val in combined.items():
                rop = reduce_items[key][0]
                if key in st:
                    val = rop.pairwise(st[key][1], val)
                st[key] = ("repl", val)

        if aggregate:
            issue_prefetch(si)

    result = dict(env)
    for key, lay in rp.final_layout.items():
        if lay == REPLICATED:
            result[key] = st[key][1]
            continue
        _, stacks, bases, covers, prior, _ = st[key]
        flat = flat2(mesh.join(stacks, ax_i, 1), lay.covers)
        flat = flat.to(env[key].dtype if key in env else flat.dtype)
        if lay.has_prior:
            full = prior.clone()
            (bi, bj), (ci, cj) = lay.bases, lay.covers
            full[bi:bi + ci, bj:bj + cj] = flat.to(full.dtype)
            result[key] = full
        else:
            result[key] = flat
    return result
