"""Workload-distribution planning (paper §3.1.3).

The planning work is organised as the first three passes of the
:func:`repro_torch.core.api.compile` pipeline:

* :func:`analyze_program`  — the **analyze** pass: loop/nest
  canonicalisation (§3.1.2) + context analysis (§3.1.1),
* :func:`plan_schedule`    — the **schedule** pass: chunking math
  (§3.1.3, Table 2),
* :func:`decide_strategies` — the **plan** pass: one transfer strategy
  per shared variable, fused into a :class:`DistPlan`.

``make_plan`` composes the three (the one-call planning surface).  The
strategies are the SPMD renditions of the paper's transfer rules
(counterpart of :mod:`repro.core.plan`, decision for decision):

==================  =====================================================
strategy            paper rule it implements
==================  =====================================================
replicate_in        IN variable: master sends the buffer to every worker
                    (SPMD: replicated ``in_specs``)
shard_in            IN/INOUT read ``x[i]``: master sends only the chunk's
                    slice (SPMD: cyclic-reshaped sharded input slab)
shard_out_identity  OUT/INOUT write ``x[i]`` covering the whole leading
                    dim: workers return only their slices (SPMD: sharded
                    output slab, reassembled by layout)
partial_identity    same but covering rows ``[b, b+T)`` only: slices are
                    written back into the master copy
scatter_psum        affine-but-strided write ``x[a*i+b]``: each worker
                    returns a masked full-size buffer, combined with a
                    psum and merged into the master copy (the paper's
                    "transfer the full modified array" case)
put_broadcast       iterator not on the leading dim: the full array is
                    taken from the worker that ran the *last* chunk
reduce_psum/...     reduction clause: identity-init partials + op-matched
                    cross-device combine
==================  =====================================================

Writes whose index is not affine in the iterator are rejected with
:class:`LoopNotCanonical` — the paper keeps such blocks as OpenMP.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from repro_torch.core import context as ctx_mod
from repro_torch.core import pragma
from repro_torch.core import schedule as schedule_mod
from repro_torch.core.context import ReadKind, VarClass, WriteKind
from repro_torch.core.loop import LoopInfo, LoopNotCanonical
from repro_torch.core.nest import LoopNest, NestAffine


@dataclasses.dataclass(frozen=True)
class KAffine:
    """Index map rebased to iteration number k in [0, T): ``a*k + b``."""

    a: int
    b: int

    @classmethod
    def from_iter_affine(cls, aff: ctx_mod.Affine, loop: LoopInfo) -> "KAffine":
        return cls(a=aff.a * loop.step, b=aff.a * loop.start + aff.b)

    def position(self, k: int) -> int:
        return self.a * k + self.b

    @property
    def is_identity(self) -> bool:
        return self.a == 1 and self.b == 0


def _k_axis_maps(aff: NestAffine, nest: LoopNest) -> tuple[KAffine, ...] | None:
    """Rebase a rank-2 :class:`NestAffine` to k-space and require it to
    follow exactly one nest axis (``a*k_d + b``); returns the per-axis
    :class:`KAffine` view ``(axis, KAffine)``-style or None when the map
    mixes axes (non-separable — the paper keeps such blocks as OpenMP)."""
    k = aff.k_space(nest)
    hits = [d for d, a in enumerate(k.coeffs) if a != 0]
    if len(hits) > 1:
        return None
    d = hits[0] if hits else 0
    return (d, KAffine(k.coeffs[d] if hits else 0, k.b))


@dataclasses.dataclass
class VarDecision:
    key: str
    klass: VarClass
    in_strategy: str            # "replicate" | "shard" | "shard_halo"
                                # | "none"
    out_strategy: str           # "none" | "identity" | "partial" | "scatter"
                                # | "put" | "reduce"
    read_map: KAffine | None = None
    write_map: KAffine | None = None
    reduction_op: str | None = None
    halo: tuple[int, int] | None = None   # (bk_min, bk_max) for stencils
    note: str = ""
    # rank-2 nests: per-buffer-axis k-space maps and halo windows; the
    # leading ``shard_ndim`` buffer axes are chunk-distributed (buffer
    # axis d follows nest axis d)
    read_maps: tuple | None = None        # per-axis KAffine (sharded axes)
    write_maps: tuple | None = None       # per-axis KAffine for at((i,j),v)
    halo_axes: tuple | None = None        # per-axis (b_min, b_max)
    shard_ndim: int = 0

    def window(self, axis: int = 0) -> tuple[int, int]:
        """``(b_min, b_max)`` of a sharded input's chunk window along
        ``axis``: its halo, ``(0, 0)`` for a plain ``shard``."""
        if self.in_strategy != "shard_halo":
            return (0, 0)
        if self.halo_axes is not None:
            return self.halo_axes[axis]
        return self.halo


@dataclasses.dataclass
class DistPlan:
    name: str
    loop: LoopInfo
    chunks: schedule_mod.ChunkPlan
    vars: dict[str, VarDecision]
    axis: str | tuple
    lowering: str
    shard_inputs: bool
    context: ctx_mod.ContextInfo
    nest: LoopNest | None = None
    chunks_axes: tuple = ()

    def __post_init__(self) -> None:
        if self.nest is None:
            self.nest = LoopNest((self.loop,))
        if not self.chunks_axes:
            self.chunks_axes = (self.chunks,)

    @property
    def rank(self) -> int:
        return self.nest.rank

    @property
    def axes_names(self) -> tuple[str, ...]:
        return self.axis if isinstance(self.axis, tuple) else (self.axis,)

    @property
    def sharded_in_keys(self) -> list[str]:
        return [k for k, v in self.vars.items()
                if v.in_strategy in ("shard", "shard_halo")]

    @property
    def written_keys(self) -> list[str]:
        """Buffers the block writes (any out strategy), sorted."""
        return sorted(k for k, v in self.vars.items()
                      if v.out_strategy != "none")

    @property
    def replicated_in_keys(self) -> list[str]:
        return [k for k, v in self.vars.items() if v.in_strategy == "replicate"]


def analyze_program(
    program: pragma.ParallelFor,
    env: Mapping[str, Any],
    device=None,
) -> tuple[LoopNest, ctx_mod.ContextInfo]:
    """Compiler pass **analyze**: canonicalise the loop nest (§3.1.2)
    and run Context Analysis over the traced body (§3.1.1).

    Returns the :class:`LoopNest` IR plus the per-buffer
    :class:`~repro_torch.core.context.ContextInfo` — the artifact every later
    pass consumes."""
    nest = LoopNest.from_program(program)
    ctx = ctx_mod.analyze_context(program, env, nest, device)
    return nest, ctx


def plan_schedule(
    program: pragma.ParallelFor,
    nest: LoopNest,
    num_devices: int | tuple,
    *,
    lowering: str = "collective",
    paper_master_excluded: bool | None = None,
    schedule: pragma.Schedule | None = None,
    weights=None,
) -> tuple:
    """Compiler pass **schedule**: the chunking math of §3.1.3 (Table 2)
    as per-axis :class:`~repro_torch.core.schedule.ChunkPlan`\\ s.

    ``schedule`` overrides the program's own clause (the
    :class:`~repro_torch.core.api.Options` schedule override); ``None`` keeps
    the clause written on the pragma.  ``weights`` (per-device, per-axis
    for rank 2) switches the cyclic deal to the straggler-weighted one
    — collective lowering only (the master/worker row math and the
    fused ring exchanges assume cyclic ownership)."""
    if weights is not None and lowering != "collective":
        raise LoopNotCanonical(
            "straggler-weighted schedules require the collective "
            f"lowering, not {lowering!r}")
    if nest.rank == 2:
        scheds = ((schedule,) * nest.rank if schedule is not None
                  else program.schedules)
        return schedule_mod.make_nest_chunk_plans(
            nest, scheds, num_devices, weights=weights)
    sched = schedule if schedule is not None else program.schedule
    if weights is not None and not any(
            e is None or hasattr(e, "__len__") for e in weights):
        weights = (weights,)    # flat rank-1 vector -> per-axis form
    w0 = weights[0] if weights is not None else None
    if paper_master_excluded is None:
        paper_master_excluded = lowering == "master_worker"

    compute_devices = num_devices
    if lowering == "master_worker":
        if num_devices < 2:
            raise LoopNotCanonical(
                "master_worker lowering needs >= 2 devices (rank 0 is the master)"
            )
        if num_devices > 64:
            raise LoopNotCanonical(
                "master_worker lowering emits O(P) point-to-point permutes; "
                "use lowering='collective' beyond 64 devices"
            )
        if paper_master_excluded:
            compute_devices = num_devices - 1

    return (schedule_mod.make_chunk_plan(
        nest.axes[0], sched, compute_devices,
        paper_master_excluded=False,  # already folded into compute_devices
        weights=w0,
    ),)


def make_plan(
    program: pragma.ParallelFor,
    env: Mapping[str, Any],
    num_devices: int | tuple,
    *,
    axis: str | tuple = "data",
    lowering: str = "collective",
    shard_inputs: bool = False,
    paper_master_excluded: bool | None = None,
    schedule: pragma.Schedule | None = None,
    weights=None,
    device=None,
) -> DistPlan:
    """analyze → schedule → plan, composed (the historical one-call
    planning surface; :func:`repro_torch.core.api.compile` runs the passes
    individually so each artifact is recorded)."""
    if lowering not in ("collective", "master_worker"):
        raise ValueError(f"unknown lowering {lowering!r}")
    if program.rank == 2:
        if lowering != "collective":
            raise LoopNotCanonical(
                "collapse=2 nests only lower through the collective path "
                "(the paper's master/worker staging is rank-1 only)")
        if not isinstance(axis, tuple) or len(axis) != 2:
            raise ValueError(
                f"collapse=2 needs a 2-tuple of mesh axes, got {axis!r}")
        if not isinstance(num_devices, tuple) or len(num_devices) != 2:
            raise ValueError(
                f"collapse=2 needs per-axis device counts, got {num_devices!r}")
    elif isinstance(axis, tuple) or isinstance(num_devices, tuple):
        raise LoopNotCanonical(
            "a 2-D mesh axis tuple needs a collapse=2 nest; transform "
            "rank-1 loops over a single named axis")

    nest, ctx = analyze_program(program, env, device)
    chunks_axes = plan_schedule(
        program, nest, num_devices, lowering=lowering,
        paper_master_excluded=paper_master_excluded, schedule=schedule,
        weights=weights)
    return decide_strategies(
        program, nest, ctx, chunks_axes, axis=axis, lowering=lowering,
        shard_inputs=shard_inputs)


def decide_strategies(
    program: pragma.ParallelFor,
    nest: LoopNest,
    ctx: ctx_mod.ContextInfo,
    chunks_axes: tuple,
    *,
    axis: str | tuple = "data",
    lowering: str = "collective",
    shard_inputs: bool = False,
) -> DistPlan:
    """Compiler pass **plan**: fold the analyze + schedule artifacts into
    one transfer strategy per shared variable (paper §3.1.3's workload
    distribution decisions), returning the :class:`DistPlan`."""
    if nest.rank == 2:
        return _decide_strategies2(
            program, nest, ctx, chunks_axes, axis=axis, lowering=lowering,
            shard_inputs=shard_inputs)
    loop = nest.axes[0]
    chunks = chunks_axes[0]

    decisions: dict[str, VarDecision] = {}
    t = loop.trip_count
    for key, info in ctx.vars.items():
        read_map = None
        if info.read.kind == ReadKind.SLICED and info.read.affine is not None:
            read_map = KAffine.from_iter_affine(info.read.affine, loop)

        write_map = None
        out_strategy = "none"
        note = ""
        w = info.write
        if w.kind == WriteKind.AT:
            if w.affine is None:
                raise LoopNotCanonical(
                    f"write index of {key!r} is not an affine function of the "
                    "iterator (paper §3.1.3: block kept as OpenMP)"
                )
            write_map = KAffine.from_iter_affine(w.affine, loop)
            if write_map.a == 0 and t > 1:
                raise LoopNotCanonical(
                    f"{key!r}: every iteration writes the same element "
                    "(concurrent access; paper §3.1.3 refuses to divide)"
                )
            shape0 = info.shape[0] if info.shape else 0
            if tuple(w.value_shape) != tuple(info.shape[1:]):
                raise LoopNotCanonical(
                    f"{key!r}: per-iteration value shape {w.value_shape} does "
                    f"not match buffer row shape {info.shape[1:]}"
                )
            lo = min(write_map.position(0), write_map.position(max(0, t - 1)))
            hi = max(write_map.position(0), write_map.position(max(0, t - 1)))
            if t > 0 and (lo < 0 or hi >= shape0):
                raise LoopNotCanonical(
                    f"{key!r}: write positions [{lo}, {hi}] out of bounds for "
                    f"leading dim {shape0}"
                )
            if write_map.is_identity and t == shape0:
                out_strategy = "identity"
            elif write_map.a == 1 and 0 <= write_map.b and write_map.b + t <= shape0:
                out_strategy = "partial"
                note = f"rows [{write_map.b}, {write_map.b + t}) updated in place"
            else:
                out_strategy = "scatter"
                note = (
                    "strided affine write: full-size masked psum combine "
                    "(paper: whole modified array is transferred)"
                )
        elif w.kind == WriteKind.PUT:
            out_strategy = "put"
            if tuple(w.value_shape) != tuple(info.shape):
                raise LoopNotCanonical(
                    f"{key!r}: omp.put value shape {w.value_shape} != buffer "
                    f"shape {info.shape}"
                )
            note = "full array taken from the worker owning the last iteration"
        elif w.kind == WriteKind.RED:
            out_strategy = "reduce"

        # Input strategy: shard only when every read is the identity slice
        # x[k-affine-identity]; stencils (several unit-stride maps) shard
        # with a halo; everything else replicates (the paper's
        # master->worker full-buffer send).
        in_strategy = "none"
        halo = None
        if info.read.kind == ReadKind.WHOLE:
            in_strategy = "replicate"
        elif info.read.kind == ReadKind.SLICED:
            in_strategy = "replicate"
            if (shard_inputs and lowering == "collective"
                    and read_map is not None and info.shape):
                if read_map.is_identity and info.shape[0] == t:
                    in_strategy = "shard"
                elif (read_map.a == 1 and read_map.b >= 0
                      and read_map.b + t <= info.shape[0]):
                    # aligned unit-stride read x[k+b]: sharded slab with
                    # a degenerate (b, b) halo window — each chunk gets
                    # exactly the rows it reads (beyond-paper; enables
                    # inter-loop residency for partial-cover chains)
                    in_strategy = "shard_halo"
                    halo = (read_map.b, read_map.b)
        elif info.read.kind == ReadKind.STENCIL:
            kmaps = [KAffine.from_iter_affine(a, loop)
                     for a in info.read.affines]
            eligible = (
                shard_inputs
                and lowering == "collective"
                and all(m.a == 1 for m in kmaps)
                and info.shape
                # every read in-bounds across the iteration space
                and min(m.b for m in kmaps) >= 0
                and max(m.b for m in kmaps) + t <= info.shape[0]
            )
            if eligible:
                in_strategy = "shard_halo"
                halo = (min(m.b for m in kmaps), max(m.b for m in kmaps))
                note = (note + "; " if note else "") + (
                    f"stencil halo rows [{halo[0]}, {halo[1]}] exchanged "
                    "instead of replicating the buffer (beyond-paper)")
            else:
                in_strategy = "replicate"
        # partial/scatter merges re-read the master copy outside shard_map;
        # no extra in-strategy needed for that.

        decisions[key] = VarDecision(
            key=key,
            klass=info.klass,
            in_strategy=in_strategy,
            out_strategy=out_strategy,
            read_map=read_map,
            write_map=write_map,
            reduction_op=w.reduction_op,
            halo=halo,
            note=note,
        )

    return DistPlan(
        name=program.name,
        loop=loop,
        chunks=chunks,
        vars=decisions,
        axis=axis,
        lowering=lowering,
        shard_inputs=shard_inputs,
        context=ctx,
    )


# ---------------------------------------------------------------------------
# Rank-2 nests (``collapse=2``) over 2-D meshes
# ---------------------------------------------------------------------------


def _decide_strategies2(
    program: pragma.ParallelFor,
    nest: LoopNest,
    ctx: ctx_mod.ContextInfo,
    chunks_axes: tuple,
    *,
    axis: str | tuple,
    lowering: str,
    shard_inputs: bool,
) -> DistPlan:
    """Workload distribution for a rank-2 nest: buffer axis ``d`` is
    chunk-distributed along nest axis ``d`` over mesh axis ``axis[d]``
    (the diagonal assignment; swapped/strided maps fall back to the
    paper's replicate/reject rules)."""
    trips = nest.trip_counts
    total = nest.total_trip

    decisions: dict[str, VarDecision] = {}
    for key, info in ctx.vars.items():
        out_strategy = "none"
        write_maps = None
        note = ""
        w = info.write
        if w.kind == WriteKind.AT:
            if w.affines2 is None or any(a is None for a in w.affines2):
                raise LoopNotCanonical(
                    f"write index of {key!r} is not an affine function of "
                    "the iterators (paper §3.1.3: block kept as OpenMP)")
            kmaps = [_k_axis_maps(a, nest) for a in w.affines2]
            ok = (None not in kmaps
                  and all(m[0] == d and m[1].a == 1
                          for d, m in enumerate(kmaps)))
            if not ok:
                raise LoopNotCanonical(
                    f"{key!r}: collapse=2 writes must be unit-stride per "
                    "axis (x[i+b0, j+b1]); swapped or strided maps are "
                    "kept as OpenMP blocks")
            write_maps = tuple(m[1] for m in kmaps)
            if len(info.shape) < 2:
                raise LoopNotCanonical(
                    f"{key!r}: a collapse=2 write needs a >=2-D buffer")
            if tuple(w.value_shape) != tuple(info.shape[2:]):
                raise LoopNotCanonical(
                    f"{key!r}: per-iteration value shape {w.value_shape} "
                    f"does not match buffer cell shape {info.shape[2:]}")
            if total > 0:
                for d in range(2):
                    b = write_maps[d].b
                    if b < 0 or b + trips[d] > info.shape[d]:
                        raise LoopNotCanonical(
                            f"{key!r}: axis-{d} write window [{b}, "
                            f"{b + trips[d]}) out of bounds for dim "
                            f"{info.shape[d]}")
            if (all(m.b == 0 for m in write_maps)
                    and tuple(info.shape[:2]) == trips):
                out_strategy = "identity"
            else:
                out_strategy = "partial"
                note = (f"rows [{write_maps[0].b}, "
                        f"{write_maps[0].b + trips[0]}) x cols "
                        f"[{write_maps[1].b}, {write_maps[1].b + trips[1]}) "
                        "updated in place")
        elif w.kind == WriteKind.RED:
            out_strategy = "reduce"

        # Input strategy: chunk-shard the leading buffer axes whose every
        # access follows its own nest axis with unit stride; everything
        # else replicates (the paper's master->worker full-buffer send).
        in_strategy = "none"
        read_maps = None
        halo_axes = None
        shard_ndim = 0
        if info.read.kind == ReadKind.WHOLE:
            in_strategy = "replicate"
        elif info.read.kind in (ReadKind.SLICED, ReadKind.STENCIL):
            in_strategy = "replicate"
            r = info.read.slice_ndim
            eligible = shard_inputs and r in (1, 2) and len(info.shape) >= r
            k_accesses: list[tuple[KAffine, ...]] = []
            if eligible:
                for acc in info.read.accesses:
                    kmaps = [_k_axis_maps(a, nest) for a in acc]
                    if (None in kmaps
                            or any(m[0] != d or m[1].a != 1
                                   for d, m in enumerate(kmaps))):
                        eligible = False
                        break
                    k_accesses.append(tuple(m[1] for m in kmaps))
            if eligible:
                halos = []
                for d in range(r):
                    bs = [acc[d].b for acc in k_accesses]
                    lo, hi = min(bs), max(bs)
                    if lo < 0 or hi + trips[d] > info.shape[d]:
                        eligible = False
                        break
                    halos.append((lo, hi))
                if eligible:
                    in_strategy = "shard_halo"
                    shard_ndim = r
                    halo_axes = tuple(halos)
                    read_maps = k_accesses[0]
                    if any(h != (0, 0) for h in halos):
                        note = (note + "; " if note else "") + (
                            "halo windows " + ", ".join(
                                f"axis{d} [{h[0]}, {h[1]}]"
                                for d, h in enumerate(halos))
                            + " exchanged instead of replicating")

        decisions[key] = VarDecision(
            key=key,
            klass=info.klass,
            in_strategy=in_strategy,
            out_strategy=out_strategy,
            reduction_op=w.reduction_op,
            note=note,
            read_maps=read_maps,
            write_maps=write_maps,
            halo_axes=halo_axes,
            shard_ndim=shard_ndim,
        )

    return DistPlan(
        name=program.name,
        loop=nest.axes[0],
        chunks=chunks_axes[0],
        vars=decisions,
        axis=axis,
        lowering=lowering,
        shard_inputs=shard_inputs,
        context=ctx,
        nest=nest,
        chunks_axes=chunks_axes,
    )
