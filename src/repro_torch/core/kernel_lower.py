"""``Lowering.KERNEL`` — the span kernel behind each block (counterpart of
:mod:`repro.core.pallas_lower`, block side).

The lowering keeps the whole distributed machinery of the collective
lowering — chunk-cyclic staging, the fused combines, the reassembly —
and swaps ONLY the compute phase: instead of vmapping the body over
every rank's chunks in plain PyTorch, each compute span runs as ONE
launch of the span kernel (:mod:`repro_torch.kernels.span_kernel`), a
Triton kernel generated from the body's aten graph.  A *span* is a
single loop stage, or — inside a fused region — the maximal chain of
consecutive loop stages between exchanges (:func:`compute_region_spans`):
those stages share chunk geometry and hand values to each other only
through resident slabs, so the chain runs as ONE launch whose later
stages read the earlier stages' outputs from registers (the *forwarded*
keys), while every stage's outputs are still stored for the merges.

The kernel produces only dense per-lane body values, in the global slab
layout ``(n_loc, P, c, *value_shape)`` (``(n_i, P_i, c_i, n_j, P_j, c_j,
*value_shape)`` for rank 2) — one launch covers every virtual rank.
Every merge (scatter/put/reduce folds) runs outside on those values via
:func:`merge_chunk_values`, which is also how the plain executor
(``transform._run_local_chunks``) folds: both lowerings share one merge.

On a :class:`~repro_torch.mesh.ProcessMesh` each process launches the span
kernel on its own *rank window* ``(lo, block)`` of the first nest axis's
ranks (:func:`~repro_torch.core.nest.rank_window`): the kernel generated
for that ``block`` (:func:`~repro_torch.kernels.span_kernel.generate_span`)
reads and writes ``(n_loc, block, c, ...)`` slabs and takes ``lo`` as an
argument, so every process runs one source and one compiled kernel; a
stacked mesh is the window ``(0, P)`` and generates the source it always
did.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.core import nest as nest_mod
from repro_torch.core import reduction as red_mod
from repro_torch.core.nest import AxisTiles, derive_nest_tiles
from repro_torch.kernels import span_kernel


# ---------------------------------------------------------------------------
# The KernelPlan artifact (recorded on Compiled.passes, rendered by
# report.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelSpan:
    """One span kernel: a chain of same-geometry loop stages with no
    exchange between them (one stage for a block).

    ``grid`` is the reference's per-rank grid — ``(local_chunks,
    n_tiles)``, or ``(lc_i, lc_j, nt_i, nt_j)`` for rank 2; one launch
    covers all ``ranks`` of the mesh.  It runs ``launch_programs``
    programs: the tiles of the ``slots`` (per axis) that hold an
    iteration, never the padding slots of the chunk plan, each tile in
    ``value_tiles`` programs (a tile of the output's value axis each,
    when a row-times-matrix product splits it over the grid)."""

    stage_names: tuple[str, ...]
    stage_indices: tuple[int, ...]
    rank: int
    grid: tuple[int, ...]
    tiles: tuple[AxisTiles, ...]
    forwarded: tuple[str, ...]
    n_outputs: int
    ranks: tuple[int, ...] = ()
    slots: tuple[int, ...] = ()
    value_tiles: int = 1
    source: Any = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def launch_programs(self) -> int:
        return (math.prod(self.slots) * self.value_tiles
                * math.prod(t.n_tiles for t in self.tiles))

    def describe(self) -> str:
        geo = " x ".join(
            f"{tl.n_tiles}*{tl.tile}" +
            (f" ({tl.masked_lanes} masked)" if tl.masked_lanes else "")
            for tl in self.tiles)
        ranks = "x".join(str(p) for p in self.ranks)
        slots = "x".join(str(lc * p) for lc, p in
                         zip(self.grid[:self.rank], self.ranks))
        line = (f"{'+'.join(self.stage_names)}: grid={self.grid} x "
                f"{ranks} ranks ({self.launch_programs} programs, one "
                f"launch, over the {'x'.join(map(str, self.slots))} of "
                f"{slots} chunk slots that hold iterations) tile={geo} "
                "chunk=" + "x".join(str(tl.chunk) for tl in self.tiles))
        if self.value_tiles > 1:
            line += f" x {self.value_tiles} value tiles"
        if self.forwarded:
            line += f"  register-forwarded: {', '.join(self.forwarded)}"
        return line


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """Tile geometry + spans of a KERNEL-lowered program."""

    name: str
    rank: int
    spans: tuple[KernelSpan, ...]
    n_loop_stages: int

    @property
    def n_kernels(self) -> int:
        return len(self.spans)

    @property
    def max_fused(self) -> int:
        return max((len(s.stage_names) for s in self.spans), default=0)

    def span_at(self, stage_idx: int) -> KernelSpan:
        """The span whose first stage is ``stage_idx``."""
        for s in self.spans:
            if s.stage_indices[0] == stage_idx:
                return s
        raise KeyError(stage_idx)

    def describe_lines(self) -> list[str]:
        lines = [f"span kernels: {self.n_kernels} span(s) over "
                 f"{self.n_loop_stages} loop stage(s), Triton on CUDA "
                 "(plain PyTorch for CPU tensors)"]
        for s in self.spans:
            lines.append("  " + s.describe())
        return lines


# ---------------------------------------------------------------------------
# Span planning
# ---------------------------------------------------------------------------


def _stage_geom(plan) -> tuple:
    return tuple((ch.chunk, ch.num_devices, ch.local_chunks,
                  ch.padded_trip, ch.trip_count)
                 for ch in plan.chunks_axes)


def written_key_set(plan) -> set:
    """Keys a stage writes (any out strategy)."""
    return {k for k, dec in plan.vars.items() if dec.out_strategy != "none"}


def compute_region_spans(rp) -> list[list[int]]:
    """Partition a region's executable loop stages into fusable spans.

    A stage joins the running span iff it shares chunk geometry, needs
    no gather/halo exchange, and every value it consumes is either
    external to the span or hand-off-able on chip (a resident feed from
    an in-span identity/partial producer).  Serial and zero-trip stages
    break spans (they never reach the kernel), and so does a 1-D slab of
    a 2-D nest (not lane-aligned).
    """
    spans: list[list[int]] = []
    cur: list[int] | None = None
    cur_geom = None
    written: set = set()
    for si, se in enumerate(rp.stages):
        if se.kind != "loop" or se.plan is None \
                or se.plan.nest.total_trip == 0:
            cur = None
            continue
        plan = se.plan
        geom = _stage_geom(plan)
        ok = cur is not None and not se.gathers and geom == cur_geom
        if ok:
            for key in plan.context.env_keys:
                dec = plan.vars[key]
                if dec.in_strategy == "replicate":
                    if key in written:      # produced by a pending merge
                        ok = False
                        break
                elif dec.in_strategy in ("shard", "shard_halo"):
                    feed = se.feeds.get(key, "slice")
                    if feed == "halo":      # an exchange sits between
                        ok = False
                        break
                    if key in written:
                        if feed != "resident":
                            ok = False
                            break
                        if plan.rank == 2 and dec.shard_ndim != 2:
                            ok = False      # 1-D slab of a 2-D nest
                            break
        if ok:
            cur.append(si)
        else:
            cur = [si]
            spans.append(cur)
            cur_geom = geom
            written = set()
        written |= written_key_set(plan)
    return spans


def _forwarded_per_stage(plans) -> list[tuple]:
    """Per stage, the keys it reads from an earlier span stage's tiles
    (in env-key order)."""
    out, written = [], set()
    for plan in plans:
        out.append(tuple(
            k for k in plan.context.env_keys
            if plan.vars[k].in_strategy in ("shard", "shard_halo")
            and k in written))
        written |= written_key_set(plan)
    return out


def _span_meta(plans, names, indices, source) -> KernelSpan:
    plan0 = plans[0]
    chs = plan0.chunks_axes
    # the generator's tiles: the pointwise rule, or tiles tl.dot takes
    tiles = source.tiles or derive_nest_tiles(tuple(ch.chunk for ch in chs))
    # one tile and one grid for every stage: generate_span checked it
    slots = span_kernel.live_slots(plan0)
    if plan0.rank == 1:
        grid = (chs[0].local_chunks, tiles[0].n_tiles)
    else:
        grid = (chs[0].local_chunks, chs[1].local_chunks,
                tiles[0].n_tiles, tiles[1].n_tiles)
    fwd: list[str] = []
    for keys in _forwarded_per_stage(plans):
        fwd += [k for k in keys if k not in fwd]
    return KernelSpan(stage_names=tuple(names), stage_indices=tuple(indices),
                      rank=plan0.rank, grid=grid, tiles=tiles,
                      forwarded=tuple(fwd),
                      n_outputs=sum(len(written_key_set(p)) for p in plans),
                      ranks=tuple(ch.num_devices for ch in chs),
                      slots=slots, value_tiles=source.value_tiles,
                      source=source)


def plan_block_kernel(plan, program, name: str | None = None,
                      device=None, block: int | None = None) -> KernelPlan:
    """KernelPlan of a single ParallelFor block (one span), with the span
    kernel's source generated from the body — an op the template cannot
    express raises ``CompileError`` here, at compile time.  ``block``:
    the ranks of a process's rank window (``None``: every rank)."""
    if plan.nest.total_trip == 0 or not plan.written_keys:
        return KernelPlan(name=name or plan.name, rank=plan.rank,
                          spans=(), n_loop_stages=0)
    source = span_kernel.generate(plan, program, device=device, block=block)
    span = _span_meta([plan], [name or plan.name], [0], source)
    return KernelPlan(name=name or plan.name, rank=plan.rank,
                      spans=(span,), n_loop_stages=1)


def plan_region_kernels(rp, device=None,
                        block: int | None = None) -> KernelPlan:
    """KernelPlan of a fused region: one span per exchange-free chain,
    each with ONE generated kernel (``CompileError`` at compile time for
    a body the template cannot express); ``block`` as
    :func:`plan_block_kernel`'s."""
    spans = []
    for idxs in compute_region_spans(rp):
        ses = [rp.stages[i] for i in idxs]
        plans = [se.plan for se in ses]
        fwd = _forwarded_per_stage(plans)
        source = span_kernel.generate_span(
            [(se.plan, se.stage, f) for se, f in zip(ses, fwd)], device,
            block=block)
        spans.append(_span_meta(plans, [se.name for se in ses], idxs,
                                source))
    return KernelPlan(name=rp.name, rank=rp.rank, spans=tuple(spans),
                      n_loop_stages=sum(len(s.stage_indices)
                                        for s in spans))


# ---------------------------------------------------------------------------
# Kernel execution
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SpanStage:
    """One stage's kernel-side feeds, assembled by the executor."""

    plan: Any
    program: Any
    ext_windows: dict          # key -> slab stacks in the global layout
    env_repl: dict             # key -> replicated tensor
    forwarded: frozenset = frozenset()  # keys served by earlier stages


def execute_span(stages: list[SpanStage], span: KernelSpan, device,
                 window=None) -> list[tuple[dict, dict]]:
    """Run a span's loop bodies as ONE span-kernel launch over every
    rank (a rank ``window``'s); returns each stage's per-rank ``(carry,
    ys)``, merged outside the kernel."""
    values = span_kernel.span_stage_values(stages, span.source, device,
                                           window=window)
    return [(merge_chunk_values if sp.plan.rank == 1 else
             merge_chunk_values2)(sp.plan, vals, window)
            for sp, vals in zip(stages, values)]


def run_local_chunks_kernel(plan, program, env_in, slab_stacks,
                            kernel_plan: KernelPlan, device, window=None):
    """Drop-in for ``transform._run_local_chunks``/``2`` backed by one
    span-kernel launch."""
    (span,) = kernel_plan.spans
    sp = SpanStage(plan=plan, program=program,
                   ext_windows=slab_stacks, env_repl=env_in)
    (carry, ys), = execute_span([sp], span, device, window)
    return carry, ys


# ---------------------------------------------------------------------------
# Merges — dense per-lane values -> per-rank (carry, ys)
# ---------------------------------------------------------------------------


def _valid(ch, trip: int, device, window=None):
    """``(n_loc, P, c)``: which lanes hold a real iteration, and their
    iteration numbers (``block`` ranks for a rank ``window``)."""
    _, ks = nest_mod.slot_iterations(ch, device, window)
    return ks < trip, ks


def lane_mask(plan, device, window=None) -> torch.Tensor:
    """Which lanes of the dense value layout hold a real iteration:
    ``(n_loc, P, c)``, or ``(n_i, P_i, c_i, n_j, P_j, c_j)`` for rank 2
    (``block`` in place of the first ``P`` for a rank ``window``).
    The span kernel writes these lanes, and leaves the padding slots of
    the chunk plan unwritten."""
    if plan.rank == 1:
        return _valid(plan.chunks, plan.loop.trip_count, device, window)[0]
    (ch_i, ch_j), (loop_i, loop_j) = plan.chunks_axes, plan.nest.axes
    valid_i, _ = _valid(ch_i, loop_i.trip_count, device, window)
    valid_j, _ = _valid(ch_j, loop_j.trip_count, device)
    return valid_i[:, :, :, None, None, None] & valid_j[None, None, None]


def _fold_partials(rop, v, valid, lead: tuple[int, ...]):
    """Per-rank fold of masked lane values: ``v`` has rank dims at
    ``lead`` positions among its leading lane dims; returns ``(*ranks,
    *value_shape)`` combined with the identity carry."""
    ident = red_mod.identity_like(rop, v)
    vmask = valid.reshape(valid.shape + (1,) * (v.dim() - valid.dim()))
    contrib = torch.where(vmask, v, ident)
    n_lane = valid.dim()
    rank_dims = list(lead)
    other = [d for d in range(n_lane) if d not in rank_dims]
    contrib = contrib.permute(rank_dims + other
                              + list(range(n_lane, v.dim())))
    contrib = contrib.flatten(len(rank_dims), n_lane - 1)
    part = rop.local_fold(contrib, len(rank_dims))
    carry0 = red_mod.identity_like(rop, part)
    return rop.pairwise(carry0, part)


def merge_chunk_values(plan, values, window=None):
    """``(n_loc, P, c, *value_shape)`` dense values -> per-rank ``(carry,
    ys)``: ``ys`` keeps the identity/partial values in the slab layout;
    ``carry`` holds scatter ``(buf, mask)`` pairs ``(P, *shape)`` /
    ``(P, shape0)``, put rows ``(P, *shape)`` (zeros off the owner) and
    reduction partials ``(P, *value_shape)`` — ``block`` in place of
    ``P`` for the ranks of a rank ``window`` ``(lo, block)``."""
    ch = plan.chunks
    t = plan.loop.trip_count
    lo, p = (0, ch.num_devices) if window is None else window
    device = next(iter(values.values())).device if values else None
    valid, ks = _valid(ch, t, device, window)
    carry: dict[str, Any] = {}
    ys: dict[str, Any] = {}
    for key, dec in plan.vars.items():
        if dec.out_strategy == "none":
            continue
        v = values[key]
        info = plan.context.vars[key]
        if dec.out_strategy in ("identity", "partial"):
            ys[key] = v
        elif dec.out_strategy == "scatter":
            # masked lanes land on one spare row past the end, sliced off
            # afterwards: never an out-of-range index on the device
            shape0 = info.shape[0]
            pos = torch.where(valid, dec.write_map.a * ks + dec.write_map.b,
                              shape0)
            rank = torch.arange(p, device=device).view(1, p, 1)
            flat = (rank * (shape0 + 1) + pos).reshape(-1)
            rest = tuple(info.shape[1:])
            buf = torch.zeros((p * (shape0 + 1),) + rest, dtype=info.dtype,
                              device=device)
            buf[flat] = v.reshape((-1,) + rest).to(info.dtype)
            mask = torch.zeros(p * (shape0 + 1), dtype=torch.bool,
                               device=device)
            mask[flat] = True
            carry[key] = (buf.view((p, shape0 + 1) + rest)[:, :shape0],
                          mask.view(p, shape0 + 1)[:, :shape0])
        elif dec.out_strategy == "put":
            j_star = (t - 1) // ch.chunk
            lane = (t - 1) - j_star * ch.chunk
            slots = nest_mod.slot_table(ch)
            q_star, d_star = (int(a[0]) for a in np.nonzero(slots == j_star))
            row = torch.zeros((p,) + tuple(info.shape), dtype=info.dtype,
                              device=device)
            if lo <= d_star < lo + p:
                row[d_star - lo] = v[q_star, d_star - lo, lane]
            carry[key] = row
        elif dec.out_strategy == "reduce":
            rop = red_mod.get_reduction(dec.reduction_op)
            carry[key] = _fold_partials(rop, v, valid, lead=(1,))
    return carry, ys


def merge_chunk_values2(plan, values, window=None):
    """``(n_i, P_i, c_i, n_j, P_j, c_j, *value_shape)`` dense values ->
    per-rank ``(carry, ys)``; reduction partials lead with
    ``(P_i, P_j)`` (``block`` in place of ``P_i`` for a rank
    ``window``)."""
    device = next(iter(values.values())).device if values else None
    valid = lane_mask(plan, device, window)
    carry: dict[str, Any] = {}
    ys: dict[str, Any] = {}
    for key, dec in plan.vars.items():
        if dec.out_strategy == "none":
            continue
        v = values[key]
        if dec.out_strategy in ("identity", "partial"):
            ys[key] = v
        elif dec.out_strategy == "reduce":
            rop = red_mod.get_reduction(dec.reduction_op)
            carry[key] = _fold_partials(rop, v, valid, lead=(1, 4))
    return carry, ys
