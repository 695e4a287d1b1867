"""Cost-modeled communication planning for inter-loop boundaries —
counterpart of :mod:`repro.core.comm`.

The paper's §3.1.4 moves whole arrays through rank 0 at every loop
boundary (``MPI_Send``/``MPI_Recv`` of each block's data); the region
residency planner (:mod:`repro_torch.core.region`) reduces that to one
``all_gather`` per layout-incompatible boundary.  This module picks the
boundary operator by an explicit cost model: every slab→consumer handoff
is lowered to the cheapest of four strategies

==============  =========================================================
op              when / what moves
==============  =========================================================
``resident``    producer OUT layout equals consumer IN layout: nothing
                moves
``halo``        consumer is a chunk-sharded (possibly stencil) read whose
                window only leaks ``L`` rows into the previous chunk and
                ``R`` rows into the next one: two ring ``ppermute``
                shifts move O(halo · chunks) rows instead of O(N)
``all_gather``  chunk-sharded consumer whose window cannot be served by
                neighbor shifts (or where the shifts would move more
                bytes than the gather): one ``all_gather``, then a
                local re-slice
``replicate``   the consumer needs the full buffer on every rank
                (whole-array read, serial glue, out-merge priors): the
                ``all_gather`` is forced, not chosen
==============  =========================================================

Each decision is a :class:`BoundaryComm` carrying a :class:`CommCost`
(op, payload bytes per rank, modeled total wire bytes, ring hop count)
plus the costs of the rejected alternatives; the cost model is pure
integer arithmetic and equals the reference's byte for byte.

The halo *emitters* (:func:`halo_exchange` for rank-1 slabs,
:func:`halo_exchange2` for rank-2: row-ring then column-ring shifts,
corners riding the second pass) run on the stacked-rank mesh
(:mod:`repro_torch.mesh`): a slab is one tensor in the global layout
``(n_loc, P, c, *rest)`` (``(n_i, P_i, c_i, n_j, P_j, c_j, *rest)`` for
rank 2) whose rank dim is what :meth:`~repro_torch.mesh.Mesh.ppermute`
shifts; where the reference selects on its scalar ``axis_index``, the
port selects with a per-rank index tensor broadcast along that dim.

Window geometry (all in k-space, ``0 <= b_min <= b_max`` guaranteed by
:mod:`repro_torch.core.plan` eligibility): consumer chunk ``j`` reads
positions ``[j*c + b_min, (j+1)*c - 1 + b_max]``.  Relative to a
producer slab based at ``base`` the offsets are ``delta = b - base``;
rows below the chunk's own slab rows come from the *previous* chunk's
tail (``L = max(0, -delta_min)`` rows), rows above from the *next*
chunk's head (``R = max(0, delta_max)`` rows).  Rows outside the slab's
cover ``[0, cover)`` are patched from the replicated prior copy
(partial-write producers keep one).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch


# ---------------------------------------------------------------------------
# Slab residency layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SlabLayout:
    """Chunk-cyclic residency of one buffer between stages.

    Rank ``d`` holds stacks of shape ``(local_chunks, chunk, *rest)``;
    (local chunk ``q``, lane ``r``) is global row
    ``base + (q * num_devices + d) * chunk + r``.  ``cover`` rows
    ``[base, base + cover)`` are authoritative; ``has_prior`` marks a
    partial cover whose remaining rows live in a replicated prior copy.
    """

    chunk: int
    num_devices: int
    local_chunks: int
    padded_trip: int
    base: int
    cover: int
    has_prior: bool

    @classmethod
    def of(cls, plan, *, base: int, has_prior: bool) -> "SlabLayout":
        ch = plan.chunks
        return cls(ch.chunk, ch.num_devices, ch.local_chunks,
                   ch.padded_trip, base, plan.loop.trip_count, has_prior)

    def geometry_matches(self, ch) -> bool:
        return (self.chunk == ch.chunk
                and self.num_devices == ch.num_devices
                and self.local_chunks == ch.local_chunks
                and self.padded_trip == ch.padded_trip)


@dataclasses.dataclass(frozen=True)
class AxisSlab:
    """One axis of a rank-2 chunk-cyclic residency layout."""

    chunk: int
    num_devices: int
    local_chunks: int
    padded_trip: int
    base: int
    cover: int

    def geometry_matches(self, ch) -> bool:
        return (self.chunk == ch.chunk
                and self.num_devices == ch.num_devices
                and self.local_chunks == ch.local_chunks
                and self.padded_trip == ch.padded_trip)


@dataclasses.dataclass(frozen=True)
class SlabLayout2:
    """Rank-2 chunk-cyclic residency of one buffer between stages.

    Rank ``(d_i, d_j)`` holds stacks ``(n_i, c_i, n_j, c_j, *rest)``;
    (local pair ``(q_i, q_j)``, lanes ``(r_i, r_j)``) is global cell
    ``(bases[0] + (q_i*P_i + d_i)*c_i + r_i,
       bases[1] + (q_j*P_j + d_j)*c_j + r_j)``.  The cover rectangle is
    authoritative; ``has_prior`` marks a partial cover whose remaining
    cells live in a replicated prior copy.
    """

    axes: tuple[AxisSlab, AxisSlab]
    has_prior: bool

    @classmethod
    def of(cls, plan, *, bases: tuple[int, int],
           has_prior: bool) -> "SlabLayout2":
        axs = tuple(
            AxisSlab(ch.chunk, ch.num_devices, ch.local_chunks,
                     ch.padded_trip, b, t)
            for ch, b, t in zip(plan.chunks_axes, bases,
                                plan.nest.trip_counts))
        return cls(axs, has_prior)

    @property
    def bases(self) -> tuple[int, int]:
        return tuple(a.base for a in self.axes)

    @property
    def covers(self) -> tuple[int, int]:
        return tuple(a.cover for a in self.axes)

    def geometry_matches(self, chunks_axes) -> bool:
        return len(chunks_axes) == 2 and all(
            a.geometry_matches(ch) for a, ch in zip(self.axes, chunks_axes))


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------

RESIDENT = "resident"
HALO = "halo"
ALL_GATHER = "all_gather"
REPLICATE = "replicate"

COMM_MODES = ("auto", "gather")

#: Per-launch latency term of the aggregated cost model, in wire-byte
#: equivalents (~1 us at a 50 GB/s link): launch counts and byte counts
#: add in one unit, which is what lets the scheduler
#: (:mod:`repro_torch.core.comm_schedule`) justify packing k same-boundary
#: exchanges into one payload.
ALPHA_LAUNCH_BYTES = 4096


def modeled_cost_bytes(wire_bytes: int, launches: int) -> int:
    """Latency-aware cost of a communication plan in byte equivalents:
    ``wire_bytes + ALPHA_LAUNCH_BYTES * launches``."""
    return int(wire_bytes) + ALPHA_LAUNCH_BYTES * int(launches)


@dataclasses.dataclass(frozen=True)
class CommCost:
    """Bytes-on-the-wire model of one boundary lowering.

    ``payload_bytes`` — bytes materialised at each receiving rank;
    ``wire_bytes``    — modeled total bytes crossing rank links;
    ``hops``          — ring ``ppermute`` shifts emitted (0 for resident
                        and for the collective ops).
    """

    op: str
    payload_bytes: int
    wire_bytes: int
    hops: int = 0


@dataclasses.dataclass(frozen=True)
class BoundaryComm:
    """The planned communication at one stage←buffer boundary."""

    stage: str
    key: str
    op: str
    cost: CommCost
    alternatives: Mapping[str, CommCost]
    reason: str
    # rank-1 halo: (delta_min, delta_max); rank-2: one such pair per axis
    shift: tuple | None = None

    def describe(self) -> str:
        s = (f"{self.stage} <- {self.key!r}: {self.op}"
             f" (payload ~{self.cost.payload_bytes} B/device,"
             f" wire ~{self.cost.wire_bytes} B, hops={self.cost.hops})")
        alts = [f"{op}~{c.wire_bytes} B"
                for op, c in sorted(self.alternatives.items())
                if op != self.op]
        if alts:
            s += " [rejected: " + ", ".join(alts) + "]"
        return s


def row_bytes(aval) -> int:
    """Bytes of one leading-dim row of ``aval`` (anything with ``shape``
    and a torch ``dtype``)."""
    n = 1
    for s in aval.shape[1:]:
        n *= s
    return int(n) * aval.dtype.itemsize


def full_bytes(aval) -> int:
    """Bytes of the whole ``aval`` buffer."""
    n = 1
    for s in aval.shape:
        n *= s
    return int(n) * aval.dtype.itemsize


def gather_cost(layout: SlabLayout, aval, *, op: str = ALL_GATHER) -> CommCost:
    """All_gather of the slab stacks, then a local re-slice: every rank
    receives the ``(P-1)/P`` of the padded slab it lacks."""
    row = row_bytes(aval)
    p = layout.num_devices
    wire = layout.padded_trip * row * (p - 1)
    return CommCost(op=op, payload_bytes=full_bytes(aval), wire_bytes=wire,
                    hops=0)


def halo_cost(layout: SlabLayout, aval, delta_min: int,
              delta_max: int) -> CommCost:
    """Neighbor ring shifts: each chunk sends ``L`` tail rows left-to-
    right and ``R`` head rows right-to-left (self-sends counted too —
    on one rank the gather is free and wins the comparison)."""
    row = row_bytes(aval)
    left = max(0, -delta_min)
    right = max(0, delta_max)
    num_chunks = layout.local_chunks * layout.num_devices
    wire = num_chunks * (left + right) * row
    return CommCost(
        op=HALO,
        payload_bytes=layout.local_chunks * (left + right) * row,
        wire_bytes=wire,
        hops=(1 if left else 0) + (1 if right else 0),
    )


def cell_bytes(aval, lead: int = 2) -> int:
    """Bytes of one cell of ``aval`` (everything past ``lead`` dims)."""
    n = 1
    for s in aval.shape[lead:]:
        n *= s
    return int(n) * aval.dtype.itemsize


def gather_cost2(layout: SlabLayout2, aval, *,
                 op: str = ALL_GATHER) -> CommCost:
    """All_gather of a rank-2 slab over both mesh axes, then a local
    re-slice (P = the full 2-D mesh)."""
    cell = cell_bytes(aval)
    ax_i, ax_j = layout.axes
    p = ax_i.num_devices * ax_j.num_devices
    wire = ax_i.padded_trip * ax_j.padded_trip * cell * (p - 1)
    return CommCost(op=op, payload_bytes=full_bytes(aval), wire_bytes=wire,
                    hops=0)


def halo_cost2(layout: SlabLayout2, aval, deltas) -> CommCost:
    """Row-ring + column-ring neighbor shifts for a rank-2 window: the
    row pass moves ``L_i + R_i`` lane-rows of ``c_j`` columns per chunk
    pair, the column pass ``L_j + R_j`` lane-columns of the *extended*
    ``c_i + L_i + R_i`` rows (the corners ride the second pass)."""
    cell = cell_bytes(aval)
    ax_i, ax_j = layout.axes
    (dmin_i, dmax_i), (dmin_j, dmax_j) = deltas
    li, ri = max(0, -dmin_i), max(0, dmax_i)
    lj, rj = max(0, -dmin_j), max(0, dmax_j)
    k_i = ax_i.local_chunks * ax_i.num_devices
    k_j = ax_j.local_chunks * ax_j.num_devices
    w_i = ax_i.chunk + li + ri
    per_pair = (li + ri) * ax_j.chunk + w_i * (lj + rj)
    wire = k_i * k_j * per_pair * cell
    return CommCost(
        op=HALO,
        payload_bytes=ax_i.local_chunks * ax_j.local_chunks * per_pair * cell,
        wire_bytes=wire,
        hops=sum(1 for v in (li, ri, lj, rj) if v),
    )


def plan_boundary2(
    *,
    stage: str,
    key: str,
    layout: SlabLayout2,
    chunks_axes,
    trips,
    aval,
    in_strategy: str,
    halo_axes,
    shard_ndim: int,
    needs_replicated: bool,
    mode: str = "auto",
) -> BoundaryComm:
    """Rank-2 :func:`plan_boundary`: the cheapest feasible lowering of
    one 2-D slab→consumer boundary, by the same bytes-on-the-wire
    model."""
    if mode not in COMM_MODES:
        raise ValueError(f"unknown comm mode {mode!r}; expected {COMM_MODES}")
    g_op = REPLICATE if needs_replicated else ALL_GATHER
    g_cost = gather_cost2(layout, aval, op=g_op)
    alternatives: dict[str, CommCost] = {g_op: g_cost}

    if needs_replicated or in_strategy != "shard_halo":
        return BoundaryComm(
            stage=stage, key=key, op=REPLICATE,
            cost=dataclasses.replace(g_cost, op=REPLICATE),
            alternatives=alternatives,
            reason="consumer needs the full buffer on every rank",
        )
    if shard_ndim != 2:
        return BoundaryComm(
            stage=stage, key=key, op=ALL_GATHER, cost=g_cost,
            alternatives=alternatives,
            reason="consumer shards only the leading axis of a 2-D slab",
        )
    if chunks_axes is None or not layout.geometry_matches(chunks_axes):
        return BoundaryComm(
            stage=stage, key=key, op=ALL_GATHER, cost=g_cost,
            alternatives=alternatives,
            reason="chunk geometry differs between producer and consumer",
        )

    halos = halo_axes if halo_axes is not None else ((0, 0), (0, 0))
    deltas = tuple((h[0] - a.base, h[1] - a.base)
                   for h, a in zip(halos, layout.axes))

    if all(d == (0, 0) for d in deltas) and layout.covers == tuple(trips):
        cost = CommCost(op=RESIDENT, payload_bytes=0, wire_bytes=0, hops=0)
        alternatives[RESIDENT] = cost
        return BoundaryComm(
            stage=stage, key=key, op=RESIDENT, cost=cost,
            alternatives=alternatives,
            reason="producer OUT layout equals consumer IN layout",
        )

    feasible = True
    why = ""
    for d, ((dmin, dmax), ax, h, t) in enumerate(
            zip(deltas, layout.axes, halos, trips)):
        left, right = max(0, -dmin), max(0, dmax)
        if left > ax.chunk or right > ax.chunk:
            feasible = False
            why = (f"axis-{d} halo wider than one chunk "
                   "(multi-hop exchange not emitted)")
            break
        if h[0] < ax.base and not layout.has_prior:
            feasible = False
            why = (f"axis-{d} window reads below the slab and no prior "
                   "copy exists")
            break
        if t + h[1] > ax.base + ax.cover and not layout.has_prior:
            feasible = False
            why = (f"axis-{d} window reads beyond the slab cover and no "
                   "prior copy exists")
            break

    if feasible:
        h_cost = halo_cost2(layout, aval, deltas)
        alternatives[HALO] = h_cost
        if mode == "auto" and h_cost.wire_bytes < g_cost.wire_bytes:
            return BoundaryComm(
                stage=stage, key=key, op=HALO, cost=h_cost,
                alternatives=alternatives,
                reason=(f"row+column neighbor shifts move "
                        f"{h_cost.wire_bytes} B vs {g_cost.wire_bytes} B "
                        "for the gather"),
                shift=deltas,
            )
        why = ("comm mode 'gather' pins the all-gather baseline" if mode != "auto"
               else f"gather is no more expensive "
                    f"({g_cost.wire_bytes} B <= {h_cost.wire_bytes} B)")

    return BoundaryComm(
        stage=stage, key=key, op=ALL_GATHER, cost=g_cost,
        alternatives=alternatives, reason=why,
    )


def plan_boundary(
    *,
    stage: str,
    key: str,
    layout: SlabLayout,
    chunks,
    trip: int,
    aval,
    in_strategy: str,
    halo: tuple[int, int] | None,
    needs_replicated: bool,
    mode: str = "auto",
) -> BoundaryComm:
    """Pick the cheapest feasible lowering for one slab→consumer boundary.

    ``needs_replicated`` marks consumers that must see the full buffer
    (whole-array reads, out-merge priors): the gather is then forced and
    reported as ``replicate``.  ``mode="gather"`` disables the halo
    strategy (the all-gather baseline, kept for measurement).
    """
    if mode not in COMM_MODES:
        raise ValueError(f"unknown comm mode {mode!r}; expected {COMM_MODES}")
    g_op = REPLICATE if needs_replicated else ALL_GATHER
    g_cost = gather_cost(layout, aval, op=g_op)
    alternatives: dict[str, CommCost] = {g_op: g_cost}

    if needs_replicated or in_strategy not in ("shard", "shard_halo"):
        return BoundaryComm(
            stage=stage, key=key, op=REPLICATE,
            cost=dataclasses.replace(g_cost, op=REPLICATE),
            alternatives=alternatives,
            reason="consumer needs the full buffer on every rank",
        )

    b_min, b_max = halo if halo is not None else (0, 0)
    if chunks is None or not layout.geometry_matches(chunks):
        return BoundaryComm(
            stage=stage, key=key, op=ALL_GATHER, cost=g_cost,
            alternatives=alternatives,
            reason="chunk geometry differs between producer and consumer",
        )

    delta_min = b_min - layout.base
    delta_max = b_max - layout.base

    if delta_min == 0 and delta_max == 0 and layout.cover == trip:
        cost = CommCost(op=RESIDENT, payload_bytes=0, wire_bytes=0, hops=0)
        alternatives[RESIDENT] = cost
        return BoundaryComm(
            stage=stage, key=key, op=RESIDENT, cost=cost,
            alternatives=alternatives,
            reason="producer OUT layout equals consumer IN layout",
        )

    # halo feasibility: one-hop shifts, and any window rows falling
    # outside the slab's cover must be servable from a replicated prior
    left = max(0, -delta_min)
    right = max(0, delta_max)
    feasible = left <= layout.chunk and right <= layout.chunk
    why = "halo wider than one chunk (multi-hop exchange not emitted)"
    if feasible and b_min < layout.base and not layout.has_prior:
        feasible = False
        why = "window reads below the slab and no prior copy exists"
    if (feasible and trip + b_max > layout.base + layout.cover
            and not layout.has_prior):
        feasible = False
        why = "window reads beyond the slab cover and no prior copy exists"

    if feasible:
        h_cost = halo_cost(layout, aval, delta_min, delta_max)
        alternatives[HALO] = h_cost
        if mode == "auto" and h_cost.wire_bytes < g_cost.wire_bytes:
            return BoundaryComm(
                stage=stage, key=key, op=HALO, cost=h_cost,
                alternatives=alternatives,
                reason=(f"neighbor shifts move {h_cost.wire_bytes} B vs "
                        f"{g_cost.wire_bytes} B for the gather"),
                shift=(delta_min, delta_max),
            )
        why = ("comm mode 'gather' pins the all-gather baseline" if mode != "auto"
               else f"gather is no more expensive "
                    f"({g_cost.wire_bytes} B <= {h_cost.wire_bytes} B)")

    return BoundaryComm(
        stage=stage, key=key, op=ALL_GATHER, cost=g_cost,
        alternatives=alternatives, reason=why,
    )


# ---------------------------------------------------------------------------
# The halo emitters (stacked-rank mesh)
# ---------------------------------------------------------------------------


def _rank_index(mesh, axis: str, ndim: int) -> torch.Tensor:
    """Every rank's index along ``axis``, shaped to broadcast along the
    leading rank dim of an ``ndim``-dim per-rank tensor."""
    return mesh.axis_index(axis).reshape((-1,) + (1,) * (ndim - 1))


def ring_recv(mesh, payload, *, axis: str, num_devices: int, side: str):
    """One ring shift of per-rank ``(P, n_loc, rows, ...)`` payloads and
    the chunk-adjacency fix-up: ``side="left"`` delivers every chunk its
    predecessor's payload (chunk ``j-1`` is rank ``d-1``'s chunk at the
    same local index, except on rank 0, where it is the last rank's
    *previous* local chunk); ``side="right"`` its successor's."""
    p = num_devices
    step = -1 if side == "left" else 1
    recv = mesh.ppermute(payload, axis,
                         perm=[((i + step) % p, i) for i in range(p)])
    return ring_fixup(mesh, recv, axis=axis, num_devices=p, side=side)


def ring_fixup(mesh, recv, *, axis: str, num_devices: int, side: str):
    """The local-chunk roll of :func:`ring_recv` on an already shifted
    payload (shared with the packed emitters)."""
    d = _rank_index(mesh, axis, recv.dim())
    if side == "left":
        rolled = torch.cat([recv[:, :1], recv[:, :-1]], dim=1)
        return torch.where(d == 0, rolled, recv)
    rolled = torch.cat([recv[:, 1:], recv[:, -1:]], dim=1)
    return torch.where(d == num_devices - 1, rolled, recv)


def ring_parts(x, chunk: int, delta_min: int, delta_max: int):
    """``(left payload, own rows, right payload)`` of per-rank stacks
    ``x`` = ``(P, n_loc, chunk, ...)``; absent sides are ``None``."""
    c = chunk
    left, right = max(0, -delta_min), max(0, delta_max)
    if left > c or right > c:
        raise ValueError(
            f"halo shift ({delta_min}, {delta_max}) exceeds one chunk "
            f"(chunk={c}); the planner should have chosen a gather")
    own = x[:, :, max(0, delta_min):c + min(0, delta_max)]
    return (x[:, :, c - left:] if left else None, own,
            x[:, :, :right] if right else None)


def _ring_extend(mesh, stacks, *, axis: str, num_devices: int, chunk: int,
                 delta_min: int, delta_max: int, dims=(0, 1, 2)):
    """Widen one chunk-cyclic axis of a resident slab into read windows
    via neighbor ring shifts.  ``dims`` names the slab's (local chunk,
    rank, lane) dims; the lane dim goes from ``chunk`` to ``chunk +
    extent``.  Window row ``r`` of chunk ``j`` holds slab row
    ``j*chunk + delta_min + r`` (rows outside the producing slab are the
    caller's to patch)."""
    stack_dim, rank_dim, lane_dim = dims
    x = stacks.movedim((rank_dim, stack_dim, lane_dim), (0, 1, 2))
    tail, own, head = ring_parts(x, chunk, delta_min, delta_max)
    parts = []
    if tail is not None:
        parts.append(ring_recv(mesh, tail, axis=axis,
                               num_devices=num_devices, side="left"))
    parts.append(own)
    if head is not None:
        parts.append(ring_recv(mesh, head, axis=axis,
                               num_devices=num_devices, side="right"))
    win = parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)
    return win.movedim((0, 1, 2), (rank_dim, stack_dim, lane_dim))


def halo_exchange(
    mesh,
    stacks,
    *,
    axis: str,
    num_devices: int,
    chunk: int,
    delta_min: int,
    delta_max: int,
    prior=None,
    base: int = 0,
    cover: int | None = None,
    dtype=None,
):
    """Build every chunk's read window from a resident slab via neighbor
    ring shifts.

    ``stacks`` is the produced slab ``(n_loc, P, chunk, *rest)`` where
    (local chunk ``q``, rank ``d``, lane ``r``) is slab row
    ``(q * P + d) * chunk + r``.  Returns ``(n_loc, P, width, *rest)``
    windows whose row ``r`` holds slab row ``j*chunk + delta_min + r`` —
    the layout :func:`repro_torch.core.nest.halo_slabs` stages from a
    replicated copy, so the consumer's window indexing is the same on
    both paths.  Rows outside the slab's ``[0, cover)`` are patched from
    the replicated ``prior`` copy; remaining out-of-range rows are only
    consumed by masked padding lanes.  On a process mesh ``stacks`` holds
    the process's ranks (``block`` in place of ``P``), and so do the
    windows.
    """
    win = _ring_extend(mesh, stacks, axis=axis, num_devices=num_devices,
                       chunk=chunk, delta_min=delta_min,
                       delta_max=delta_max)
    return patch_window_prior(win, chunk=chunk, delta_min=delta_min,
                              prior=prior, base=base, cover=cover,
                              dtype=dtype,
                              ranks=(mesh.local_ranks(axis).start,
                                     num_devices))


def _window_positions(n_loc, p, width, c, delta_min, device, ranks=None):
    """k-space positions ``(n_loc, P, width)`` of every window relative
    to the producing slab's base (chunk ``j = q*P + d``); ``ranks = (lo,
    P)`` for windows of ranks ``lo .. lo + p - 1`` of ``P``."""
    if ranks is None or ranks == (0, p):
        j = torch.arange(n_loc * p, device=device).reshape(n_loc, p, 1)
    else:
        lo, p_total = ranks
        j = (torch.arange(n_loc, device=device).reshape(n_loc, 1, 1)
             * p_total + lo + torch.arange(p, device=device).reshape(1, p, 1))
    return j * c + delta_min + torch.arange(width, device=device)


def patch_window_prior(win, *, chunk: int, delta_min: int, prior=None,
                       base: int = 0, cover: int | None = None, dtype=None,
                       ranks=None):
    """Patch window rows outside the slab's ``[0, cover)`` from the
    replicated ``prior`` copy and cast to the consumer dtype — the
    non-communicating half of :func:`halo_exchange`, shared with the
    packed emitters (:mod:`repro_torch.core.comm_schedule`).  ``ranks =
    (lo, P)``: ``win`` holds ranks ``lo ..`` of ``P`` (default: all)."""
    if prior is not None:
        n_loc, p, width = win.shape[:3]
        rho = _window_positions(n_loc, p, width, chunk, delta_min,
                                win.device, ranks)
        pos = (base + rho).clamp(0, prior.shape[0] - 1)
        pvals = prior[pos]
        p_total = p if ranks is None else ranks[1]
        cov = cover if cover is not None else n_loc * p_total * chunk
        inside = (rho >= 0) & (rho < cov)
        mask = inside.reshape(inside.shape + (1,) * (win.dim() - 3))
        win = torch.where(mask, win, pvals.to(win.dtype))
    if dtype is not None:
        win = win.to(dtype)
    return win


def halo_exchange2(
    mesh,
    stacks,
    *,
    axes: tuple[str, str],
    num_devices: tuple[int, int],
    chunks: tuple[int, int],
    deltas,
    prior=None,
    bases: tuple[int, int] = (0, 0),
    covers: tuple[int, int] | None = None,
    dtype=None,
):
    """Rank-2 halo exchange: every (chunk_i, chunk_j) pair's 2-D read
    window from a resident slab ``(n_i, P_i, c_i, n_j, P_j, c_j, *rest)``
    via row-ring then column-ring shifts; returns ``(n_i, P_i, w_i, n_j,
    P_j, w_j, *rest)``.  The column pass widens the *already-extended*
    windows, so the corner blocks travel two hops (no diagonal sends).
    Positions outside the slab's cover rectangle are patched from the
    replicated ``prior`` copy.  On a process mesh ``stacks`` holds the
    process's ``i`` ranks; the column pass's payloads carry them
    (:meth:`Mesh.carrying`)."""
    (p_i, p_j) = num_devices
    (c_i, c_j) = chunks
    (dmin_i, dmax_i), (dmin_j, dmax_j) = deltas
    mine = mesh.local_ranks(axes[0])
    win = _ring_extend(mesh, stacks, axis=axes[0], num_devices=p_i,
                       chunk=c_i, delta_min=dmin_i, delta_max=dmax_i,
                       dims=(0, 1, 2))
    win = _ring_extend(mesh.carrying(axes[0]), win, axis=axes[1],
                       num_devices=p_j, chunk=c_j, delta_min=dmin_j,
                       delta_max=dmax_j, dims=(3, 4, 5))
    return patch_window_prior2(win, chunks=chunks, deltas=deltas,
                               prior=prior, bases=bases, covers=covers,
                               dtype=dtype, ranks=(mine.start, p_i))


def patch_window_prior2(win, *, chunks: tuple[int, int], deltas, prior=None,
                        bases: tuple[int, int] = (0, 0),
                        covers: tuple[int, int] | None = None, dtype=None,
                        ranks=None):
    """Rank-2 :func:`patch_window_prior`: patch positions outside the
    slab's cover rectangle from the replicated ``prior`` copy; ``ranks =
    (lo, P_i)`` for windows of the ``i`` ranks ``lo ..`` of ``P_i``."""
    (c_i, c_j) = chunks
    (dmin_i, _), (dmin_j, _) = deltas
    if prior is not None:
        n_i, p_i, w_i, n_j, p_j, w_j = win.shape[:6]
        rho_i = _window_positions(n_i, p_i, w_i, c_i, dmin_i, win.device,
                                  ranks)
        rho_j = _window_positions(n_j, p_j, w_j, c_j, dmin_j, win.device)
        pos_i = (bases[0] + rho_i).clamp(0, prior.shape[0] - 1)
        pos_j = (bases[1] + rho_j).clamp(0, prior.shape[1] - 1)
        pvals = prior[pos_i[:, :, :, None, None, None],
                      pos_j[None, None, None]]
        pt_i = p_i if ranks is None else ranks[1]
        cov_i = covers[0] if covers is not None else n_i * pt_i * c_i
        cov_j = covers[1] if covers is not None else n_j * p_j * c_j
        inside = (((rho_i >= 0) & (rho_i < cov_i))[:, :, :, None, None, None]
                  & ((rho_j >= 0) & (rho_j < cov_j))[None, None, None])
        mask = inside.reshape(inside.shape + (1,) * (win.dim() - 6))
        win = torch.where(mask, win, pvals.to(win.dtype))
    if dtype is not None:
        win = win.to(dtype)
    return win


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------


def plan_comm(
    region,
    env: Mapping[str, Any],
    num_devices: int | tuple,
    *,
    axis: str | tuple | None = None,
    comm: str = "auto",
) -> list[BoundaryComm]:
    """Plan every inter-loop boundary of a region: one
    :class:`BoundaryComm` per slab handoff, in stage order.

    Accepts a :class:`~repro_torch.core.pragma.ParallelRegion` (or a
    single :class:`~repro_torch.core.pragma.ParallelFor`, wrapped) plus
    example inputs or shapes; rank-2 regions take per-axis device counts,
    e.g. ``num_devices=(4, 2)``.  The same decisions the fused lowering
    executes."""
    from repro_torch.core import pragma
    from repro_torch.core.region import plan_region

    if isinstance(region, pragma.ParallelFor):
        region = pragma.ParallelRegion((region,))
    if region.rank == 2:
        if axis is None:
            axis = ("i", "j")
        if not isinstance(num_devices, tuple):
            raise ValueError(
                "collapse=2 regions need per-axis device counts, "
                f"e.g. num_devices=(4, 2); got {num_devices!r}")
    elif axis is None:
        axis = "data"
    rp = plan_region(region, env, num_devices, axis=axis, comm=comm)
    return rp.comms
