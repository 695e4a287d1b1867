"""``omp.compile`` — the staged compiler entry point (counterpart of
:mod:`repro.core.api`).

One call

    compiled = omp.compile(program, mesh, omp.Options(...))

runs the pass pipeline

    analyze  →  schedule  →  plan  →  plan_comm  →  schedule_comm  →  lower

(plus a 7th **kernel** pass under ``Lowering.KERNEL``), recording each
stage's artifact on ``compiled.passes``.  A single block has no
inter-loop boundaries, so plan_comm and schedule_comm record empty
artifacts; its per-block combines fuse at lower.  A ``ParallelRegion``
plans as a whole under ``Lowering.FUSED`` (the default) and
``Lowering.KERNEL``: the residency planner's
:class:`~repro_torch.core.region.RegionPlan`, its boundary exchanges and
their :class:`~repro_torch.core.comm_schedule.CommSchedule`; under
``Lowering.COLLECTIVE`` each loop plans in isolation (per-loop
staging).

Options are validated at construction with the reference's messages
(:class:`CompileError`); compiles are cached under a structural key
(program signature, mesh shape/axes/device, Options, env shapes).  With
:func:`enable_persistent_cache` (or ``$REPRO_AOT_CACHE_DIR``) compiles
also persist across processes through the versioned store of
:mod:`repro_torch.core.aot_store`: a cold build stores its planned
artifacts (and, after its first run on the card, the cubin of each span
kernel), and a fresh process pointed at the same directory restores
them instead of planning and compiling; the pass records rebuild lazily
when inspected.
"""
from __future__ import annotations

import dataclasses
import enum
import io
import itertools
import math
import os
import pickle
import threading
from typing import Any, Mapping

import torch

from repro_torch.core import aot_store as aot_store_mod
from repro_torch.core import pragma
from repro_torch.core import plan as plan_mod
from repro_torch.core.context import TensorSpec, spec_of
from repro_torch.core.loop import LoopNotCanonical


class CompileError(LoopNotCanonical, ValueError):
    """Invalid :class:`Options`, an option × program combination the
    compiler cannot honor, or a body the span kernel cannot express.

    Subclasses :class:`~repro_torch.core.loop.LoopNotCanonical` *and*
    :class:`ValueError`, as the reference's does."""


class Lowering(enum.Enum):
    """How the parallel block(s) are lowered to the mesh."""

    FUSED = "fused"
    """One fused program for a whole region (the default): slabs stay
    resident between loops, boundaries become halo exchanges or gathers;
    a single ``ParallelFor`` has no boundaries to fuse, so it equals
    COLLECTIVE there."""

    COLLECTIVE = "collective"
    """Per-loop staging: chunk-cyclic slabs + balanced collectives, the
    chunk compute in plain PyTorch."""

    MASTER_WORKER = "master_worker"
    """Paper-faithful Fig. 1b staging: rank 0 is the master, which sends
    every worker its inputs and gathers their chunks back."""

    KERNEL = "kernel"
    """COLLECTIVE (a block) or FUSED (a region) with each compute span —
    a block, or a chain of exchange-free region stages — run as ONE
    launch of the span kernel (:mod:`repro_torch.kernels.span_kernel`,
    Triton on CUDA; the plain PyTorch version for CPU tensors)."""


class CommMode(enum.Enum):
    """Boundary planner mode for fused regions."""

    AUTO = "auto"
    GATHER = "gather"


class ShardPolicy(enum.Enum):
    """IN-buffer transfer policy for the per-loop staging lowerings."""

    REPLICATE = "replicate"
    """The paper's rule: the master broadcasts every IN buffer."""

    SLICE = "slice"
    """Send each rank only its chunk slices (+ stencil halo rows)."""


def _coerce_enum(enum_cls, value, field):
    if isinstance(value, enum_cls):
        return value
    if isinstance(value, str):
        try:
            return enum_cls(value.lower())
        except ValueError:
            pass
    raise CompileError(
        f"Options.{field} must be one of "
        f"{[e.value for e in enum_cls]} (or a {enum_cls.__name__}), "
        f"got {value!r}")


def _normalize_chunk_weights(cw):
    """A flat tuple of floats (rank 1), or a 2-tuple of per-axis entries
    (each a float tuple or ``None``) for ``collapse=2``."""

    def flat(seq, where):
        try:
            vals = tuple(float(x) for x in seq)
        except (TypeError, ValueError):
            raise CompileError(
                f"Options.chunk_weights{where} must be a sequence of "
                f"numbers, got {seq!r}") from None
        if not vals:
            raise CompileError(f"Options.chunk_weights{where} is empty")
        for v in vals:
            if not math.isfinite(v) or v <= 0:
                raise CompileError(
                    f"Options.chunk_weights{where} entries must be "
                    f"finite and > 0, got {vals}")
        return vals

    if not isinstance(cw, (tuple, list)):
        raise CompileError(
            "Options.chunk_weights must be a per-device weight vector "
            "(or a 2-tuple of per-axis vectors for collapse=2), got "
            f"{cw!r}")
    if any(e is None or isinstance(e, (tuple, list)) for e in cw):
        if len(cw) != 2 or not all(
                e is None or isinstance(e, (tuple, list)) for e in cw):
            raise CompileError(
                "per-axis Options.chunk_weights must be a 2-tuple of "
                f"weight vectors (or None per axis), got {cw!r}")
        return tuple(None if e is None else flat(e, f"[{d}]")
                     for d, e in enumerate(cw))
    return flat(cw, "")


@dataclasses.dataclass(frozen=True)
class Options:
    """Compilation options; every field accepts the enum member or its
    string value and is validated at construction."""

    axis: Any = None
    lowering: Lowering = Lowering.FUSED
    comm: CommMode = CommMode.AUTO
    shard: ShardPolicy = ShardPolicy.REPLICATE
    comm_schedule: str = "aggregate"
    schedule: pragma.Schedule | None = None
    keep_sharded: bool = False
    unroll_chunks: bool = False
    """Accepted for parity with the reference; the port's chunk loop is a
    vmap, so there is nothing to unroll."""
    paper_master_excluded: bool | None = None
    chunk_weights: Any = None

    def __post_init__(self) -> None:
        from repro_torch.core.comm_schedule import SCHEDULE_MODES

        object.__setattr__(
            self, "lowering",
            _coerce_enum(Lowering, self.lowering, "lowering"))
        object.__setattr__(
            self, "comm", _coerce_enum(CommMode, self.comm, "comm"))
        object.__setattr__(
            self, "shard", _coerce_enum(ShardPolicy, self.shard, "shard"))

        cs = self.comm_schedule
        if isinstance(cs, str):
            cs = cs.lower()
        if cs not in SCHEDULE_MODES:
            raise CompileError(
                f"Options.comm_schedule must be one of {SCHEDULE_MODES}, "
                f"got {self.comm_schedule!r}")
        object.__setattr__(self, "comm_schedule", cs)

        sched = self.schedule
        if isinstance(sched, str):
            try:
                sched = pragma.Schedule(sched)
            except ValueError as e:
                raise CompileError(f"Options.schedule: {e}") from None
            object.__setattr__(self, "schedule", sched)
        elif sched is not None and not isinstance(sched, pragma.Schedule):
            raise CompileError(
                "Options.schedule must be a Schedule (omp.static()/"
                f"omp.dynamic()/omp.guided()) or None, got {sched!r}")

        if self.keep_sharded:
            raise CompileError(
                "Options.keep_sharded=True: sharded-exit control is not "
                "implemented by any lowering — outputs are always "
                "reassembled to the shared-memory layout at exit.  To keep "
                "arrays resident between loops, compile them as one "
                "omp.region(...) with Lowering.FUSED (the default)."
            )

        ax = self.axis
        if ax is not None:
            if isinstance(ax, list):
                ax = tuple(ax)
                object.__setattr__(self, "axis", ax)
            if isinstance(ax, tuple):
                if (len(ax) != 2 or not all(isinstance(a, str) for a in ax)
                        or ax[0] == ax[1]):
                    raise CompileError(
                        "Options.axis: a rank-2 axis clause must be a "
                        f"2-tuple of distinct mesh axis names, got {ax!r}")
            elif not isinstance(ax, str):
                raise CompileError(
                    "Options.axis must be a mesh axis name, a 2-tuple of "
                    f"names, or None, got {ax!r}")

        if not isinstance(self.unroll_chunks, bool):
            raise CompileError(
                f"Options.unroll_chunks must be a bool, "
                f"got {self.unroll_chunks!r}")
        if self.paper_master_excluded not in (None, True, False):
            raise CompileError(
                "Options.paper_master_excluded must be True, False or None "
                f"(= derive from the lowering), got "
                f"{self.paper_master_excluded!r}")

        if self.lowering is Lowering.KERNEL:
            if self.unroll_chunks:
                raise CompileError(
                    "Options.unroll_chunks has no effect under "
                    "Lowering.KERNEL: chunk compute runs as one span-kernel "
                    "grid, not a loop that could be unrolled.  Drop "
                    "unroll_chunks or use Lowering.FUSED/COLLECTIVE.")
            if self.paper_master_excluded is not None:
                raise CompileError(
                    "Options.paper_master_excluded is a master/worker "
                    "staging knob; Lowering.KERNEL never stages through "
                    "a master rank (and Lowering.MASTER_WORKER has no "
                    "kernel variant).  Drop paper_master_excluded or "
                    "use Lowering.MASTER_WORKER.")

        if self.chunk_weights is not None:
            object.__setattr__(self, "chunk_weights",
                               _normalize_chunk_weights(self.chunk_weights))
            if self.lowering in (Lowering.MASTER_WORKER, Lowering.KERNEL):
                raise CompileError(
                    "Options.chunk_weights (straggler-weighted schedule) "
                    "requires the collective chunk executor; "
                    f"lowering={self.lowering.value!r} assumes cyclic "
                    "chunk ownership (explicit master/worker row math / "
                    "tiled kernel grids).  Use Lowering.COLLECTIVE, or "
                    "the default FUSED on a single block.")

    def describe(self) -> str:
        sched = (f"{self.schedule.kind}({self.schedule.chunk})"
                 if self.schedule is not None else "per-pragma")
        return (f"lowering={self.lowering.value} comm={self.comm.value} "
                f"comm_schedule={self.comm_schedule} "
                f"shard={self.shard.value} schedule={sched}")


# ---------------------------------------------------------------------------
# Pass records
# ---------------------------------------------------------------------------

PASS_NAMES = ("analyze", "schedule", "plan", "plan_comm", "schedule_comm",
              "lower")


@dataclasses.dataclass(frozen=True)
class PassRecord:
    """One pipeline stage: what went in, what came out."""

    name: str
    input: str
    output: Any

    def describe(self) -> str:
        out = self.output
        if isinstance(out, (tuple, list)):
            kind = f"{len(out)} artifact(s)"
        else:
            kind = type(out).__name__
        return f"{self.name}: {self.input} -> {kind}"


# ---------------------------------------------------------------------------
# The structural compilation cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Artifacts:
    """Result of the analyze→kernel passes; ``program`` pins the
    ``id()``s used in the cache key."""

    passes: tuple[PassRecord, ...]
    exe_plan: Any
    program: Any


class _Counter:
    """Increment-only counter, exact under threads."""

    __slots__ = ("_n", "_lock")

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def inc(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def value(self) -> int:
        return self._n


class _Entry:
    """One cache line: the artifacts plus an LRU recency stamp."""

    __slots__ = ("art", "stamp")

    def __init__(self, art: _Artifacts, stamp: int) -> None:
        self.art = art
        self.stamp = stamp


_CACHE: dict[tuple, _Entry] = {}
_CACHE_CAP = 512
_CACHE_LOCK = threading.Lock()   # guards the miss path: insert + evict
_TICK = itertools.count()        # LRU clock
_HITS = _Counter()
_MISSES = _Counter()

# The persistent store (None: in-memory only), enabled by
# enable_persistent_cache() or $REPRO_AOT_CACHE_DIR.
_PERSISTENT: aot_store_mod.AOTStore | None = None
_RESTORED: dict[str, "_Stored"] = {}   # disk key -> entry read or written
_UNEXPORTABLE: set[str] = set()        # disk keys that cannot be stored


def compile_cache_stats() -> dict:
    """Hit/miss counters and current size of the compilation cache, plus
    the persistent store's counters (``disk_hits`` / ``disk_misses`` /
    ``disk_errors`` / ``disk_bytes_read`` / ``disk_bytes_written`` /
    ``evictions`` / ``evicted_bytes``; zeros while persistence is off)
    and its directory (``persistent_dir``)."""
    stats = {"hits": _HITS.value, "misses": _MISSES.value,
             "size": len(_CACHE),
             "persistent_dir": _PERSISTENT.path if _PERSISTENT else None}
    stats.update(_PERSISTENT.stats if _PERSISTENT
                 else aot_store_mod.empty_stats())
    return stats


def clear_compile_cache() -> None:
    """Drop every cached compilation and reset the counters (the
    persistent store keeps its entries on disk; its counters reset)."""
    global _HITS, _MISSES
    with _CACHE_LOCK:
        _CACHE.clear()
        _RESTORED.clear()
        _UNEXPORTABLE.clear()
        _HITS = _Counter()
        _MISSES = _Counter()
        if _PERSISTENT is not None:
            _PERSISTENT.stats = aot_store_mod.empty_stats()


def enable_persistent_cache(path: str | None = None) -> str:
    """Turn on the on-disk store at ``path`` (default:
    ``$REPRO_AOT_CACHE_DIR`` or ``~/.cache/repro-aot``); returns the
    resolved directory.  Compiles gain a disk probe on the miss path and
    a save on cold builds; a fresh process pointed at the same directory
    restores the planned artifacts (and the span kernels' cubins)
    instead of planning and compiling."""
    global _PERSISTENT
    if path is None:
        path = os.environ.get(aot_store_mod.ENV_VAR) or os.path.join(
            os.path.expanduser("~"), ".cache", "repro-aot")
    _PERSISTENT = aot_store_mod.AOTStore(path)
    return _PERSISTENT.path


def disable_persistent_cache() -> None:
    """Back to in-memory-only caching (the entries stay on disk)."""
    global _PERSISTENT
    _PERSISTENT = None
    _RESTORED.clear()
    _UNEXPORTABLE.clear()


if os.environ.get(aot_store_mod.ENV_VAR):
    enable_persistent_cache()


def _program_signature(p) -> tuple:
    """Structural identity of a program (bodies by ``id()``; cache
    entries keep the program alive so ids cannot be recycled)."""
    if isinstance(p, pragma.ParallelRegion):
        return ("region", tuple(_program_signature(s) for s in p.stages))
    if isinstance(p, pragma.SerialStage):
        return ("serial", id(p.fn), p.reads)
    return ("for", id(p.body), p.bounds, p.collapse,
            (p.schedule.kind, p.schedule.chunk),
            tuple(sorted(p.reduction.items())))


def _env_signature(env: Mapping[str, Any]) -> tuple:
    """Shape/dtype identity of the environment, without touching data."""
    sig = []
    for k in sorted(env):
        s = spec_of(env[k])
        sig.append((k, tuple(s.shape), str(s.dtype)))
    return tuple(sig)


def _mesh_signature(mesh) -> tuple:
    """The mesh's shape and device; a process mesh adds its world size
    and rank block (the same on every process: a process's artifacts
    never depend on which ranks it holds), so that a process mesh and a
    stacked mesh of one shape never share an artifact."""
    sig = (tuple((str(a), int(mesh.shape[a])) for a in mesh.axis_names),
           str(mesh.device))
    if _is_process_mesh(mesh):
        sig += (("processes", mesh.processes, mesh.split_axis, mesh.block),)
    return sig


def _is_process_mesh(mesh) -> bool:
    from repro_torch.mesh import ProcessMesh

    return isinstance(mesh, ProcessMesh)


def _stable_program_token(p) -> tuple:
    """Cross-process counterpart of :func:`_program_signature` for the
    persistent store: loop bodies hash by bytecode + consts + closure
    values (:func:`repro_torch.core.aot_store.fingerprint`), not by
    ``id()``, so the same source program keys alike in every process."""
    if isinstance(p, pragma.ParallelRegion):
        return ("region",
                tuple(_stable_program_token(s) for s in p.stages))
    if isinstance(p, pragma.SerialStage):
        return ("serial", aot_store_mod.fingerprint(p.fn), p.reads)
    return ("for", aot_store_mod.fingerprint(p.body), p.bounds, p.collapse,
            (p.schedule.kind, p.schedule.chunk),
            tuple(sorted(p.reduction.items())))


# ---------------------------------------------------------------------------
# What the persistent store keeps
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Stored:
    """One store entry: what the executor is built from, as data — the
    plan (``exe_plan``), the ``kernel`` pass's plan (``kernel``, or None)
    and, once a run on the card compiled them, each span kernel's cubins
    (``cubins``: see :func:`repro_torch.kernels.span_kernel.export_cubins`).
    Loop bodies are not stored: the caller's program supplies them, and
    the disk key (a fingerprint of their bytecode) guarantees they are
    the same code."""

    exe_plan: Any
    kernel: Any
    cubins: dict = dataclasses.field(default_factory=dict)


def _program_objects(program) -> dict:
    """``{token: obj}`` of the program, its stages and their loop bodies /
    glue functions: the objects an entry refers to and does not store."""
    stages = (program.stages if isinstance(program, pragma.ParallelRegion)
              else (program,))
    objs = {("part", "program"): program}
    for i, st in enumerate(stages):
        objs[("part", "stage", i)] = st
        objs[("part", "fn", i)] = (st.fn if isinstance(st, pragma.SerialStage)
                                   else st.body)
    return objs


class _EntryPickler(pickle.Pickler):
    """Pickles an entry with the program's objects as references (the
    traced aten graphs of the analysis are left out: only the span
    kernel's generator reads them, and it re-traces)."""

    def __init__(self, fh, parts: dict):
        super().__init__(fh, protocol=pickle.HIGHEST_PROTOCOL)
        self._parts = parts

    def persistent_id(self, obj):
        from repro_torch.core.context import BodyTrace

        token = self._parts.get(id(obj))
        if token is not None:
            return token
        if isinstance(obj, BodyTrace):
            return ("trace",)
        return None


class _EntryUnpickler(pickle.Unpickler):
    def __init__(self, fh, objs: dict):
        super().__init__(fh)
        self._objs = objs

    def persistent_load(self, pid):
        if pid == ("trace",):
            return None
        return self._objs[pid]


def _encode(program, stored: _Stored) -> bytes | None:
    """The entry's body, or None where the plan holds something that is
    not data (its key then builds cold in every process)."""
    buf = io.BytesIO()
    try:
        _EntryPickler(buf, {id(obj): tok for tok, obj in
                            _program_objects(program).items()}).dump(stored)
    except (pickle.PicklingError, TypeError, AttributeError, RuntimeError):
        return None
    return buf.getvalue()


def _decoder(program):
    """The decoder of an entry whose references resolve into
    ``program``."""
    objs = _program_objects(program)

    def decode(body: bytes) -> _Stored:
        out = _EntryUnpickler(io.BytesIO(body), objs).load()
        if not isinstance(out, _Stored):
            raise ValueError("not a compile entry")
        return out
    return decode


# ---------------------------------------------------------------------------
# compile()
# ---------------------------------------------------------------------------


def compile(
    program,
    mesh,
    options: Options | None = None,
    *,
    env_like: Mapping[str, Any] | None = None,
    **overrides,
) -> "Compiled":
    """Compile a :class:`~repro_torch.core.pragma.ParallelFor` or
    :class:`~repro_torch.core.pragma.ParallelRegion` to a distributed
    program on ``mesh`` (a :class:`repro_torch.mesh.Mesh`).

    On a :class:`~repro_torch.mesh.ProcessMesh` every process compiles
    the same program and calls ``run`` with the same whole env; each
    stages and computes its own ranks of the first nest axis, and each
    returns the whole result, the stacked mesh's bit for bit (a rank-2
    nest whose ``j`` axis the processes split raises
    ``NotImplementedError``).

    ``options`` carries every knob, or the fields come as keyword
    overrides.  ``env_like`` (shapes only) runs the pipeline eagerly;
    without it the pipeline runs on first call.
    """
    from repro_torch.core import nest as nest_mod
    from repro_torch.core import transform as tf

    if options is None:
        options = Options(**overrides)
    elif overrides:
        raise CompileError(
            "pass either an Options object or keyword overrides, not both "
            f"(got Options plus {sorted(overrides)})")
    if not isinstance(options, Options):
        raise CompileError(
            f"options must be an omp.Options, got {type(options).__name__}")
    if not isinstance(program, (pragma.ParallelFor, pragma.ParallelRegion)):
        raise CompileError(
            "omp.compile expects a ParallelFor or ParallelRegion, got "
            f"{type(program).__name__}")

    axis, num = tf.resolve_axes(program, mesh, options.axis)
    nest_mod.rank_window(mesh, axis)    # a process mesh it cannot split
    _validate_combination(program, options, num)
    compiled = Compiled(program=program, mesh=mesh, options=options,
                        axis=axis, num_devices=num)
    if env_like is not None:
        compiled._ensure(env_like)
    return compiled


def _validate_combination(program, options: Options, num) -> None:
    """Cross-field validation that needs the program (the reference's
    diagnostics, block cases)."""
    rank = program.rank
    if options.lowering is Lowering.MASTER_WORKER:
        if rank == 2:
            raise CompileError(
                "Lowering.MASTER_WORKER × collapse=2: the paper's "
                "master/worker staging is rank-1 only.  Use "
                "Lowering.FUSED (default) or Lowering.COLLECTIVE for "
                "rank-2 nests.")
        if options.shard is ShardPolicy.SLICE:
            raise CompileError(
                "ShardPolicy.SLICE has no effect under "
                "Lowering.MASTER_WORKER (the master always sends full "
                "buffers, paper Fig. 1b); use Lowering.COLLECTIVE for "
                "sliced inputs.")
        if num < 2:
            raise CompileError(
                "Lowering.MASTER_WORKER needs >= 2 mesh ranks (rank 0 is "
                f"the master); this mesh has {num}.")

    cw = options.chunk_weights
    if cw is not None:
        if isinstance(program, pragma.ParallelRegion) \
                and options.lowering is Lowering.FUSED:
            raise CompileError(
                "Options.chunk_weights on a region requires "
                "Lowering.COLLECTIVE (per-loop staging): the fused "
                "region executor's ring halo exchanges and slab "
                "residency assume cyclic chunk ownership.")
        nested = any(e is None or isinstance(e, tuple) for e in cw)
        if rank == 2:
            if not nested:
                raise CompileError(
                    "collapse=2 needs per-axis chunk_weights: a 2-tuple "
                    "of weight vectors (or None to keep an axis "
                    f"cyclic), got {cw!r}")
            for d, (e, p_d) in enumerate(zip(cw, num)):
                if e is not None and len(e) != p_d:
                    raise CompileError(
                        f"chunk_weights[{d}] has {len(e)} entries but "
                        f"mesh axis {d} has {p_d} devices")
        else:
            if nested:
                raise CompileError(
                    "rank-1 loops need a flat per-device chunk_weights "
                    f"vector, got the per-axis form {cw!r}")
            if len(cw) != num:
                raise CompileError(
                    f"chunk_weights has {len(cw)} entries but the mesh "
                    f"axis has {num} devices")


# ---------------------------------------------------------------------------
# Pipeline execution
# ---------------------------------------------------------------------------


def _lowering_str(options: Options) -> str:
    return ("master_worker" if options.lowering is Lowering.MASTER_WORKER
            else "collective")


def _build_block(program, env_shapes, num, axis, options,
                 device, block=None) -> _Artifacts:
    low = _lowering_str(options)
    shard_inputs = options.shard is ShardPolicy.SLICE
    nest, ctx = plan_mod.analyze_program(program, env_shapes, device)
    chunks_axes = plan_mod.plan_schedule(
        program, nest, num, lowering=low,
        paper_master_excluded=options.paper_master_excluded,
        schedule=options.schedule, weights=options.chunk_weights)
    plan = plan_mod.decide_strategies(
        program, nest, ctx, chunks_axes, axis=axis, lowering=low,
        shard_inputs=shard_inputs)
    passes = (
        PassRecord("analyze",
                   input=f"block {program.name!r} + env shapes",
                   output=(nest, ctx)),
        PassRecord("schedule",
                   input="loop nest + schedule clause(s)",
                   output=chunks_axes),
        PassRecord("plan",
                   input="context + chunk plans",
                   output=plan),
        PassRecord("plan_comm",
                   input="single block: no inter-loop slab boundaries",
                   output=()),
        PassRecord("schedule_comm",
                   input="single block: no region-wide exchanges to "
                         "schedule (per-block combines fuse at lower)",
                   output=()),
    )
    if options.lowering is Lowering.KERNEL:
        from repro_torch.core import kernel_lower as kl

        passes = passes + (PassRecord(
            "kernel",
            input="compute span + chunk geometry (tile derivation per axis, "
                  "span kernel generated from the body's aten graph)",
            output=kl.plan_block_kernel(plan, program, name=program.name,
                                        device=device, block=block)),)
    return _Artifacts(passes=passes, exe_plan=plan, program=program)


def _build_artifacts(program, env_shapes, num, axis, options,
                     device, block=None) -> _Artifacts:
    """Every pass's artifact; ``block``: the ranks of the first nest axis
    a process of a process mesh holds (``None``: every rank), for which
    the ``kernel`` pass generates its span kernels."""
    if isinstance(program, pragma.ParallelRegion):
        if options.lowering in (Lowering.FUSED, Lowering.KERNEL):
            return _build_region_fused(program, env_shapes, num, axis,
                                       options, device, block)
        return _build_region_staged(program, env_shapes, num, axis, options,
                                    device)
    return _build_block(program, env_shapes, num, axis, options, device,
                        block)


def _build_region_fused(region, env_shapes, num, axis, options,
                        device, block=None) -> _Artifacts:
    from repro_torch.core import comm_schedule as cs_mod
    from repro_torch.core import region as region_mod

    try:
        rp = region_mod.plan_region(
            region, env_shapes, num, axis=axis, comm=options.comm.value,
            schedule=options.schedule, device=device)
    except LoopNotCanonical:
        raise
    except Exception as e:
        if options.lowering is Lowering.KERNEL:
            # almost always host-side serial glue that cannot be traced on
            # the meta device: the kernel lowering runs every stage inside
            # the one fused program and cannot plan around it
            raise CompileError(
                f"Lowering.KERNEL cannot compile region {region.name!r}: "
                f"a stage is not shape-traceable "
                f"({type(e).__name__}: {e}).  Host-side serial glue "
                "(numpy conversion, I/O) runs only under the staged "
                "Lowering.COLLECTIVE path.") from e
        raise
    rp.comm_sched = cs_mod.build_comm_schedule(
        rp, mode=options.comm_schedule)
    loop_stages = [se for se in rp.stages if se.plan is not None]
    passes = (
        PassRecord("analyze",
                   input=f"region {region.name!r} "
                         f"({len(region.stages)} stages) + env shapes",
                   output=tuple((se.name, se.plan.context)
                                for se in loop_stages)),
        PassRecord("schedule",
                   input="per-stage loop nests + schedule clause(s)",
                   output=tuple((se.name, se.plan.chunks_axes)
                                for se in loop_stages)),
        PassRecord("plan",
                   input="per-stage contexts + chunk plans "
                         "(inter-loop residency planner)",
                   output=rp),
        PassRecord("plan_comm",
                   input="stage OUT layouts vs next-stage IN needs",
                   output=tuple(rp.comms)),
        PassRecord("schedule_comm",
                   input="planned boundary exchanges + stage order "
                         "(aggregate payloads / fuse combines / hoist "
                         "to producers)",
                   output=rp.comm_sched),
    )
    if options.lowering is Lowering.KERNEL:
        from repro_torch.core import kernel_lower as kl

        passes = passes + (PassRecord(
            "kernel",
            input="exchange-free compute spans + chunk geometry (one span "
                  "kernel per span, generated from the stages' aten "
                  "graphs)",
            output=kl.plan_region_kernels(rp, device=device,
                                          block=block)),)
    return _Artifacts(passes=passes, exe_plan=rp, program=region)


def _build_region_staged(region, env_shapes, num, axis, options,
                         device) -> _Artifacts:
    """Per-loop staging (COLLECTIVE / MASTER_WORKER on a region): each
    loop planned in isolation, environment shapes threaded through the
    stages as the staged executor will see them.

    Serial glue is shape-traced on the ``meta`` device to thread its
    output shapes.  The staged executor runs glue eagerly on concrete
    tensors, so host-side glue (numpy conversion, I/O) is legal here:
    when its shapes cannot be traced, planning of the remaining stages is
    deferred to run time instead of failing the compile."""
    from repro_torch.core import region as region_mod

    low = _lowering_str(options)
    shard_inputs = options.shard is ShardPolicy.SLICE
    shapes = dict(env_shapes)
    analyses, schedules, plans = [], [], []
    deferred = None
    for stage in region.stages:
        if isinstance(stage, pragma.SerialStage):
            try:
                out_sh = region_mod.serial_out_specs(stage, shapes)
            except Exception as e:  # host-side glue: shapes unknowable
                deferred = (f"serial stage {stage.name!r} is not "
                            f"shape-traceable ({type(e).__name__}); "
                            "remaining stages plan at run time")
                break
            shapes.update(out_sh)
            continue
        nest, ctx = plan_mod.analyze_program(stage, shapes, device)
        chunks_axes = plan_mod.plan_schedule(
            stage, nest, num, lowering=low,
            paper_master_excluded=options.paper_master_excluded,
            schedule=options.schedule, weights=options.chunk_weights)
        p = plan_mod.decide_strategies(
            stage, nest, ctx, chunks_axes, axis=axis, lowering=low,
            shard_inputs=shard_inputs)
        analyses.append((stage.name, ctx))
        schedules.append((stage.name, chunks_axes))
        plans.append((stage.name, p))
        for key, dec in p.vars.items():
            if dec.out_strategy == "reduce" and key not in shapes:
                shapes[key] = region_mod._fresh_spec(p, key)
    stage_plans = tuple(plans)
    plan_input = ("per-stage contexts + chunk plans "
                  "(each loop planned in isolation)")
    if deferred is not None:
        plan_input += f"; {deferred}"
    passes = (
        PassRecord("analyze",
                   input=f"region {region.name!r} "
                         f"({len(region.stages)} stages) + env shapes",
                   output=tuple(analyses)),
        PassRecord("schedule",
                   input="per-stage loop nests + schedule clause(s)",
                   output=tuple(schedules)),
        PassRecord("plan", input=plan_input, output=stage_plans),
        PassRecord("plan_comm",
                   input="staged lowering: every boundary round-trips "
                         "through the replicated layout (paper Fig. 1b)",
                   output=()),
        PassRecord("schedule_comm",
                   input="staged lowering: no region-wide exchanges to "
                         "schedule (per-block combines fuse at lower)",
                   output=()),
    )
    return _Artifacts(
        passes=passes,
        # a partial plan list cannot feed the executor 1:1: every loop
        # then plans at run time
        exe_plan=None if deferred is not None else stage_plans,
        program=region)


def _kernel_pass(passes):
    return next((pr.output for pr in passes if pr.name == "kernel"), None)


def _make_executor(program, mesh, axis, options: Options, exe_plan,
                   kernel_plan):
    """The **lower** pass: bind the planned artifacts (the plan and the
    ``kernel`` pass's plan) to the mesh."""
    from repro_torch.core import region as region_mod
    from repro_torch.core import transform as tf

    if isinstance(program, pragma.ParallelRegion):
        fused = options.lowering in (Lowering.FUSED, Lowering.KERNEL)
        return region_mod.DistributedRegion(
            region=program, mesh=mesh,
            plan=exe_plan if fused else None,
            axis=axis, fuse=fused,
            shard_inputs=options.shard is ShardPolicy.SLICE,
            comm=options.comm.value,
            comm_schedule=options.comm_schedule,
            schedule_override=options.schedule,
            stage_plans=None if fused else exe_plan,
            lowering=_lowering_str(options),
            paper_master_excluded=options.paper_master_excluded,
            use_kernel=options.lowering is Lowering.KERNEL,
            kernel_plan=kernel_plan,
            chunk_weights=options.chunk_weights)
    return tf.DistributedProgram(
        program=program, mesh=mesh, plan=exe_plan,
        comm_schedule=options.comm_schedule,
        use_kernel=options.lowering is Lowering.KERNEL,
        kernel_plan=kernel_plan)


def _writes_store(mesh) -> bool:
    """Whether this process writes the persistent store: process 0 of a
    process mesh, and any other process alone."""
    return not _is_process_mesh(mesh) or mesh.process == 0


# ---------------------------------------------------------------------------
# The Compiled artifact
# ---------------------------------------------------------------------------

#: Fault-injection hook (:mod:`repro_torch.runtime.fault_injection`
#: installs a callable here inside ``inject()``).  Called as
#: ``hook("run")`` at every ``Compiled.run`` entry and ``hook("run_exit",
#: out)`` on exit (the return value replaces ``out``: output corruption
#: faults).  ``None`` in production: one check per call.
_fault_hook = None


@dataclasses.dataclass
class Compiled:
    """The compilation artifact of a block or a region: callable
    (``compiled(env)`` / ``compiled.run(env)``), with ``.passes``,
    ``.plan``, ``.boundaries``, ``.comm_schedule``, ``.kernel_plan``,
    ``.report()``, ``.cost_summary()`` and ``.cache_hit``."""

    program: Any
    mesh: Any
    options: Options
    axis: Any
    num_devices: Any
    cache_hit: bool | None = None
    _exe: Any = dataclasses.field(default=None, repr=False)
    _passes: tuple | None = dataclasses.field(default=None, repr=False)
    _env_sig: tuple | None = dataclasses.field(default=None, repr=False)
    # Persistent-store state: after a restore that skipped planning, the
    # env specs to rebuild the pass records with when inspected; after a
    # cold build on the card, the entry whose span kernels' cubins the
    # first run adds.
    _restored_env: Any = dataclasses.field(default=None, repr=False)
    _cubins_due: Any = dataclasses.field(default=None, repr=False)

    def run(self, env: Mapping[str, Any]) -> dict:
        """Execute on the mesh's device; an env tensor on another device
        raises."""
        from repro_torch.core import transform as tf

        if _fault_hook is not None:
            _fault_hook("run")
        env = tf.check_env(env, self.mesh.device)
        self._ensure(env)
        out = self._exe(env)
        if self._cubins_due is not None:
            self._store_cubins()
        if _fault_hook is not None:
            out = _fault_hook("run_exit", out)
        return out

    __call__ = run

    @property
    def restored(self) -> bool:
        """Whether this artifact was served from the persistent store
        (planning skipped; the pass records rebuild when inspected)."""
        return self._restored_env is not None

    def _ensure(self, env_like: Mapping[str, Any], *,
                allow_restore: bool = True) -> None:
        from repro_torch.core import nest as nest_mod

        sig = _env_signature(env_like)
        if sig == self._env_sig and self._exe is not None:
            return
        key = (_program_signature(self.program), _mesh_signature(self.mesh),
               self.options, sig)
        entry = _CACHE.get(key)          # warm hits: lock-free
        if entry is not None:
            _HITS.inc()
            entry.stamp = next(_TICK)
            self.cache_hit = True
            self._bind(entry.art, sig)
            return
        if allow_restore and _PERSISTENT is not None:
            if _is_process_mesh(self.mesh):
                # every process looks at the store as it stands after the
                # commits before this one: they hit or miss together
                import torch.distributed as dist

                dist.barrier(group=self.mesh.group)
            if self._try_restore(sig):
                return
        _MISSES.inc()
        self.cache_hit = False
        env_shapes = {k: spec_of(v) for k, v in env_like.items()}
        window = nest_mod.rank_window(self.mesh, self.axis)
        art = _build_artifacts(self.program, env_shapes, self.num_devices,
                               self.axis, self.options, self.mesh.device,
                               None if window is None else window[1])
        with _CACHE_LOCK:
            _CACHE[key] = _Entry(art, next(_TICK))
            while len(_CACHE) > _CACHE_CAP:
                oldest = min(_CACHE, key=lambda k: _CACHE[k].stamp)
                del _CACHE[oldest]
        self._bind(art, sig)
        if _PERSISTENT is not None:
            self._save(sig, art)

    def _bind(self, art: _Artifacts, sig: tuple) -> None:
        exe = _make_executor(self.program, self.mesh, self.axis,
                             self.options, art.exe_plan,
                             _kernel_pass(art.passes))
        self._passes = art.passes + (PassRecord(
            "lower", input="planned artifacts + mesh", output=exe),)
        self._exe = exe
        self._env_sig = sig

    # -- the persistent store ----------------------------------------------

    def _disk_key(self, sig: tuple) -> str:
        return aot_store_mod.fingerprint(
            "compiled-run", aot_store_mod.STORE_VERSION,
            _stable_program_token(self.program),
            _mesh_signature(self.mesh), self.options, self.axis, sig)

    def _save(self, sig: tuple, art: _Artifacts) -> None:
        """Store a cold build's planned artifacts (a staged plan deferred
        to run time, or a plan that is not data, cannot be stored: its
        key builds cold in every process).  On the card, the first run
        adds the span kernels' cubins (:meth:`_store_cubins`).  Over a
        process mesh every process builds the same artifacts and process
        0 alone writes them (every process may read)."""
        dkey = self._disk_key(sig)
        if dkey in _UNEXPORTABLE or dkey in _RESTORED:
            return
        stored = _Stored(art.exe_plan, _kernel_pass(art.passes))
        body = (None if art.exe_plan is None
                else _encode(self.program, stored))
        if body is None:
            _UNEXPORTABLE.add(dkey)
            return
        if _writes_store(self.mesh):
            _PERSISTENT.save(dkey, body, self.mesh.device)
        _RESTORED[dkey] = stored
        if (self.mesh.device.type == "cuda" and stored.kernel is not None
                and stored.kernel.spans):
            self._cubins_due = dkey, stored

    def _store_cubins(self) -> None:
        """After the first run of a cold build on the card: the entry
        again, with the cubin Triton compiled for each span kernel."""
        from repro_torch.kernels import span_kernel

        dkey, stored = self._cubins_due
        self._cubins_due = None
        stored.cubins = span_kernel.export_cubins(stored.kernel)
        body = _encode(self.program, stored)
        if (_PERSISTENT is not None and body is not None and stored.cubins
                and _writes_store(self.mesh)):
            _PERSISTENT.save(dkey, body, self.mesh.device)

    def _try_restore(self, sig: tuple) -> bool:
        """Serve this compile from the persistent store: planning is
        skipped (the pass records rebuild when inspected), and on the
        card each stored cubin is loaded for K1's launcher, so no span
        kernel is compiled.  A cubin that does not load counts as a store
        error, and its span kernel then builds cold through Triton (the
        same kernel)."""
        dkey = self._disk_key(sig)
        if dkey in _UNEXPORTABLE:
            return False
        stored = _RESTORED.get(dkey)
        if stored is None:
            stored = _PERSISTENT.load(dkey, self.mesh.device,
                                      _decoder(self.program))
            if stored is None:
                return False
            _RESTORED[dkey] = stored
            if stored.cubins and self.mesh.device.type == "cuda":
                from repro_torch.kernels import span_kernel

                _PERSISTENT.stats["disk_errors"] += span_kernel.import_cubins(
                    stored.kernel, stored.cubins, self.mesh.device)
        self.cache_hit = True
        self._exe = _make_executor(self.program, self.mesh, self.axis,
                                   self.options, stored.exe_plan,
                                   stored.kernel)
        self._passes = None
        self._env_sig = sig
        self._restored_env = {
            k: TensorSpec(tuple(sh), getattr(torch, dt.replace("torch.", "")))
            for k, sh, dt in sig}
        return True

    def _built(self) -> None:
        if self._passes is None and self._restored_env is not None:
            self._env_sig = None
            self._ensure(self._restored_env, allow_restore=False)
        if self._passes is None:
            raise CompileError(
                "the pass pipeline has not run yet: call the compiled "
                "program (or compile with env_like=) to build the plan "
                "before inspecting it")

    @property
    def passes(self) -> tuple:
        self._built()
        return self._passes

    def _pass(self, name: str) -> PassRecord:
        self._built()
        for pr in self._passes:
            if pr.name == name:
                return pr
        raise KeyError(name)

    @property
    def plan(self):
        """The planning artifact: a :class:`~repro_torch.core.plan.DistPlan`
        for a block, a :class:`~repro_torch.core.region.RegionPlan` for a
        fused region, per-stage ``(name, DistPlan)`` pairs for a staged
        region."""
        return self._pass("plan").output

    @property
    def boundaries(self) -> tuple:
        """The planned boundary exchanges (empty for single blocks and
        staged regions)."""
        return self._pass("plan_comm").output

    @property
    def comm_schedule(self):
        """The **schedule_comm** artifact: a
        :class:`~repro_torch.core.comm_schedule.CommSchedule` for fused
        regions; ``()`` for single blocks and staged regions."""
        return self._pass("schedule_comm").output

    @property
    def kernel_plan(self):
        """The **kernel** artifact (a
        :class:`~repro_torch.core.kernel_lower.KernelPlan`) under
        ``Lowering.KERNEL``; ``None`` otherwise."""
        self._built()
        for pr in self._passes:
            if pr.name == "kernel":
                return pr.output
        return None

    def report(self) -> str:
        from repro_torch.core import report as report_mod

        self._built()
        return report_mod.render_compiled(self)

    def cost_summary(self) -> dict:
        """Modeled communication totals of the chosen plan."""
        from repro_torch.core import region as region_mod
        from repro_torch.core import report as report_mod

        plan = self.plan
        base = {"lowering": self.options.lowering.value}
        if isinstance(plan, region_mod.RegionPlan):
            out = {
                "kind": "region", **base,
                "comm": plan.comm_mode,
                "planned_wire_bytes": plan.planned_wire_bytes,
                "gather_wire_bytes": plan.gather_wire_bytes,
                "n_elided": plan.n_elided,
                "n_halo": plan.n_halo,
                "n_reshards": plan.n_reshards,
            }
            sched = plan.comm_sched
            if sched is not None:
                out["comm_schedule"] = sched.mode
                out["launches_inline"] = sched.launches_inline
                out["launches_scheduled"] = sched.launches_scheduled
                out["n_hoisted"] = sched.n_hoisted
            return out
        if isinstance(plan, plan_mod.DistPlan):
            _, total = report_mod._comm_breakdown(plan)
            return {"kind": "block", **base, "modeled_bytes": total}
        total = sum(report_mod._comm_breakdown(p)[1] for _, p in plan)
        return {"kind": "region_staged", **base, "modeled_bytes": total,
                "n_loops": len(plan)}
