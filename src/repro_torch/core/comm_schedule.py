"""Region-wide communication scheduling (the ``schedule_comm`` pass) —
counterpart of :mod:`repro.core.comm_schedule`.

The cost-modeled planner (:mod:`repro_torch.core.comm`) decides *what*
each boundary moves; this pass decides *how the region moves it*: it
builds a region-wide timeline of the planned exchanges and

* **aggregates** — every buffer crossing the same (mesh-axis, shift)
  boundary at the same issue point is packed into ONE ``ppermute``
  payload per ring direction (pack → single collective → unpack; mixed
  dtypes and unequal halo widths ride a byte-level concat through
  ``uint8`` views), so k same-boundary exchanges cost one launch
  instead of k;
* **fuses** — the per-stage cross-device combines (``psum`` / ``pmax`` /
  ``pmin`` partials, scatter buf+mask pairs, ``put`` broadcasts)
  concatenate their flattened per-rank operands per (collective, dtype)
  group and cross the mesh in one collective call
  (:func:`fused_collectives`; elementwise combines commute with
  concatenation, so results equal per-operand collectives bit for bit);
* **hoists** — each exchange is issued right after its producer, so the
  fused executors *prefetch* halos before the intervening stages run.

``Options(comm_schedule="aggregate"|"inline")`` toggles it; ``inline``
pins the per-buffer behavior for measurement.  Wire bytes are identical
in both modes (packing concatenates, it never pads); what changes is the
*launch* count, which the aggregated cost model prices at
:data:`repro_torch.core.comm.ALPHA_LAUNCH_BYTES` byte-equivalents per
launch.  The mesh counts both (:attr:`repro_torch.mesh.Mesh.launches`).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Any

import torch

from repro_torch.core import comm as comm_mod
from repro_torch.core import reduction as red_mod

SCHEDULE_MODES = ("aggregate", "inline")

_FUSABLE = ("psum", "pmax", "pmin")   # Mesh methods of the same names



# ---------------------------------------------------------------------------
# Schedule IR
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CommEvent:
    """One planned halo exchange, placed in the stage timeline.

    ``shifts`` is per-axis ``(delta_min, delta_max)`` relative to the
    producing slab's base — what the ring emitters consume — and
    ``producer_idx``/``consumer_idx`` index ``RegionPlan.stages``.  The
    event is *issued* right after its producer (the hoist) and consumed
    at ``consumer_idx``.
    """

    key: str
    consumer: str
    consumer_idx: int
    producer: str
    producer_idx: int
    rank: int
    shifts: tuple                  # per-axis (delta_min, delta_max)
    chunks: tuple                  # per-axis chunk sizes
    num_devices: tuple             # per-axis ring sizes
    wire_bytes: int
    hops: int                      # inline ppermute launches

    @property
    def span(self) -> int:
        """Stages of compute the prefetch can overlap with."""
        return self.consumer_idx - self.producer_idx - 1


@dataclasses.dataclass(frozen=True)
class CommGroup:
    """Events packed into one exchange, issued after ``issue_idx``."""

    issue_idx: int
    issue_stage: str
    events: tuple[CommEvent, ...]
    launches_inline: int
    launches_packed: int

    @property
    def keys(self) -> tuple[str, ...]:
        return tuple(ev.key for ev in self.events)


@dataclasses.dataclass(frozen=True)
class ReduceFusion:
    """Per-stage fusion of cross-device combines into flat collectives."""

    stage: str
    stage_idx: int
    paths: tuple[str, ...]         # key (or key.mask) per combine operand
    launches_inline: int
    launches_fused: int            # one per (collective, dtype) group


@dataclasses.dataclass
class CommSchedule:
    """The schedule_comm artifact: the event timeline plus the launch
    accounting before/after aggregation."""

    mode: str
    rank: int
    events: tuple[CommEvent, ...]
    groups: tuple[CommGroup, ...]          # empty in inline mode
    reduce_fusions: tuple[ReduceFusion, ...]
    launches_inline: int
    launches_scheduled: int
    wire_bytes: int
    n_hoisted: int = 0                     # events with span >= 1

    def __post_init__(self) -> None:
        self._by_issue: dict[int, list[CommGroup]] = defaultdict(list)
        for g in self.groups:
            self._by_issue[g.issue_idx].append(g)

    def groups_after(self, stage_idx: int) -> list[CommGroup]:
        """Groups to issue right after ``stage_idx`` executes."""
        return self._by_issue.get(stage_idx, [])

    @property
    def launches_saved(self) -> int:
        return self.launches_inline - self.launches_scheduled

    def modeled_cost_bytes(self) -> tuple[int, int]:
        """(inline, scheduled) alpha-model costs in byte equivalents."""
        return (comm_mod.modeled_cost_bytes(self.wire_bytes,
                                            self.launches_inline),
                comm_mod.modeled_cost_bytes(self.wire_bytes,
                                            self.launches_scheduled))

    def describe_lines(self) -> list[str]:
        lines = []
        for g in self.groups:
            dests = ", ".join(
                f"{ev.key!r}->{ev.consumer}"
                + (f" (+{ev.span} stage overlap)" if ev.span else "")
                for ev in g.events)
            lines.append(
                f"after {g.issue_stage}: pack [{dests}] -> "
                f"{g.launches_packed} ppermute launch(es) "
                f"(inline: {g.launches_inline})")
        for rf in self.reduce_fusions:
            lines.append(
                f"{rf.stage}: fuse {rf.launches_inline} combine(s) "
                f"{list(rf.paths)} -> {rf.launches_fused} collective "
                "call(s)")
        before, after = self.modeled_cost_bytes()
        lines.append(
            f"collective launches: {self.launches_inline} inline -> "
            f"{self.launches_scheduled} scheduled "
            f"(alpha={comm_mod.ALPHA_LAUNCH_BYTES} B/launch: "
            f"~{before} -> ~{after} B-equiv)")
        return lines


# ---------------------------------------------------------------------------
# Building the schedule from a RegionPlan
# ---------------------------------------------------------------------------


def _packed_launches(events, rank: int) -> int:
    """Ring launches of one packed group: one per used direction per
    axis (the per-buffer payloads concat into one tensor each)."""
    n = 0
    for d in range(rank):
        if any(max(0, -ev.shifts[d][0]) > 0 for ev in events):
            n += 1
        if any(max(0, ev.shifts[d][1]) > 0 for ev in events):
            n += 1
    return n


def _stage_combines(plan, rank: int) -> list[tuple[str, str, str]]:
    """(path, collective, dtype) per cross-device combine the stage's
    output merge will issue — the fusable all-reduce population."""
    out: list[tuple[str, str, str]] = []
    for key, dec in plan.vars.items():
        if dec.out_strategy == "reduce":
            rop = red_mod.get_reduction(dec.reduction_op)
            if rop.collective in _FUSABLE:
                info = plan.context.vars[key]
                out.append((key, rop.collective,
                            str(info.write.value_dtype)))
        elif dec.out_strategy == "scatter" and rank == 1:
            info = plan.context.vars[key]
            out.append((key, "psum", str(info.dtype)))
            out.append((key + ".mask", "psum", str(torch.int32)))
        elif dec.out_strategy == "put" and rank == 1:
            info = plan.context.vars[key]
            out.append((key, "psum", str(info.dtype)))
    return out


def build_comm_schedule(rp, *, mode: str = "aggregate") -> CommSchedule:
    """Schedule a planned region's communication: the **schedule_comm**
    pass.  Walks ``rp.stages`` in order, pairing every ``halo`` feed
    with its :class:`~repro_torch.core.comm.BoundaryComm`, tracking the
    last slab writer per key (the producer), and — in ``"aggregate"``
    mode — grouping events by issue point and fusing per-stage reduction
    combines.  ``"inline"`` records the same events with no groups."""
    if mode not in SCHEDULE_MODES:
        raise ValueError(
            f"unknown comm schedule mode {mode!r}; expected {SCHEDULE_MODES}")
    rank = rp.rank
    pending: dict[tuple[str, str], deque] = defaultdict(deque)
    for bc in rp.comms:
        if bc.op == comm_mod.HALO:
            pending[(bc.stage, bc.key)].append(bc)

    events: list[CommEvent] = []
    reduce_fusions: list[ReduceFusion] = []
    reduce_inline = reduce_fused = 0
    last_writer: dict[str, tuple[int, str]] = {}
    for si, se in enumerate(rp.stages):
        if se.kind != "loop" or se.plan is None:
            continue
        plan = se.plan
        if plan.nest.total_trip == 0:
            continue
        for key, feed in se.feeds.items():
            if feed != "halo":
                continue
            bc = pending[(se.name, key)].popleft()
            prod_idx, prod_name = last_writer[key]
            if rank == 2:
                chunks = tuple(c.chunk for c in plan.chunks_axes)
                nd = tuple(c.num_devices for c in plan.chunks_axes)
                shifts = tuple(bc.shift)
            else:
                chunks = (plan.chunks.chunk,)
                nd = (plan.chunks.num_devices,)
                shifts = (bc.shift,)
            events.append(CommEvent(
                key=key, consumer=se.name, consumer_idx=si,
                producer=prod_name, producer_idx=prod_idx, rank=rank,
                shifts=shifts, chunks=chunks, num_devices=nd,
                wire_bytes=bc.cost.wire_bytes, hops=bc.cost.hops))

        combines = _stage_combines(plan, rank)
        if combines:
            kinds = {(c, dt) for _, c, dt in combines}
            reduce_inline += len(combines)
            reduce_fused += len(kinds)
            if len(combines) > len(kinds):
                reduce_fusions.append(ReduceFusion(
                    stage=se.name, stage_idx=si,
                    paths=tuple(p for p, _, _ in combines),
                    launches_inline=len(combines),
                    launches_fused=len(kinds)))

        for key, dec in plan.vars.items():
            if dec.out_strategy in ("identity", "partial"):
                last_writer[key] = (si, se.name)

    halo_inline = sum(ev.hops for ev in events)
    groups: list[CommGroup] = []
    if mode == "aggregate":
        by_issue: dict[int, list[CommEvent]] = defaultdict(list)
        for ev in events:
            by_issue[ev.producer_idx].append(ev)
        for idx in sorted(by_issue):
            evs = tuple(by_issue[idx])
            groups.append(CommGroup(
                issue_idx=idx, issue_stage=evs[0].producer, events=evs,
                launches_inline=sum(ev.hops for ev in evs),
                launches_packed=_packed_launches(evs, rank)))
        halo_sched = sum(g.launches_packed for g in groups)
        red_sched = reduce_fused
    else:
        halo_sched = halo_inline
        red_sched = reduce_inline

    return CommSchedule(
        mode=mode, rank=rank, events=tuple(events), groups=tuple(groups),
        reduce_fusions=tuple(reduce_fusions) if mode == "aggregate" else (),
        launches_inline=halo_inline + reduce_inline,
        launches_scheduled=halo_sched + red_sched,
        wire_bytes=sum(ev.wire_bytes for ev in events),
        n_hoisted=sum(1 for ev in events if ev.span >= 1),
    )


# ---------------------------------------------------------------------------
# Byte-level payload packing
# ---------------------------------------------------------------------------


def pack_payloads(arrs, lead: int = 0) -> tuple[torch.Tensor, tuple]:
    """Flatten tensors of any dtype into one ``uint8`` tensor.

    The first ``lead`` dims (per-rank dims) are kept and must agree
    across ``arrs``; everything after them concatenates byte-level
    through ``uint8`` views of contiguous copies (bools ride as
    ``uint8``).  The returned specs drive :func:`unpack_payloads`."""
    flats, specs = [], []
    for a in arrs:
        was_bool = a.dtype == torch.bool
        if was_bool:
            a = a.to(torch.uint8)
        lead_shape = tuple(a.shape[:lead])
        b = a.contiguous().reshape(lead_shape + (-1,))
        if b.dtype != torch.uint8:
            b = b.view(torch.uint8)
        specs.append((tuple(a.shape[lead:]), a.dtype, was_bool, b.shape[-1]))
        flats.append(b)
    return torch.cat(flats, dim=lead), tuple(specs)


def unpack_payloads(flat, specs) -> list:
    """Invert :func:`pack_payloads` (static offsets; the leading dims of
    ``flat`` before its last are kept)."""
    lead_shape = tuple(flat.shape[:-1])
    outs, off = [], 0
    for shape, dtype, was_bool, nbytes in specs:
        # a fresh copy: a view's storage offset may not suit the dtype
        seg = flat[..., off:off + nbytes].clone()
        off += nbytes
        a = (seg if dtype == torch.uint8 else seg.view(dtype)).reshape(
            lead_shape + shape)
        outs.append(a.to(torch.bool) if was_bool else a)
    return outs


def _packed_ppermute(mesh, payloads, axis: str, perm):
    """One ring shift for many per-rank payloads: a single payload goes
    direct (no pack/unpack); more byte-pack into ONE ``ppermute``."""
    payloads = list(payloads)
    if len(payloads) == 1:
        return [mesh.ppermute(payloads[0], axis, perm=perm)]
    flat, specs = pack_payloads(payloads, lead=1)
    return unpack_payloads(mesh.ppermute(flat, axis, perm=perm), specs)


def _ring_extend_many(mesh, entries, *, axis: str, num_devices: int,
                      dims=(0, 1, 2)):
    """Widen many chunk-cyclic slabs at once with ONE packed ``ppermute``
    per ring direction — the aggregated
    :func:`repro_torch.core.comm._ring_extend` (same chunk adjacency,
    same roll fix-ups, identical windows).

    ``entries``: ``(stacks, chunk, delta_min, delta_max)`` per buffer;
    ``dims`` names the (local chunk, rank, lane) dims of every stack.
    Halo widths may differ per buffer."""
    stack_dim, rank_dim, lane_dim = dims
    p = num_devices
    parts = [comm_mod.ring_parts(
        stacks.movedim((rank_dim, stack_dim, lane_dim), (0, 1, 2)), c,
        dmin, dmax) for stacks, c, dmin, dmax in entries]
    recv: dict[tuple[int, str], Any] = {}
    for side, pos, step in (("left", 0, -1), ("right", 2, 1)):
        ids = [k for k, pt in enumerate(parts) if pt[pos] is not None]
        if not ids:
            continue
        got = _packed_ppermute(mesh, [parts[k][pos] for k in ids], axis,
                               perm=[((i + step) % p, i) for i in range(p)])
        for k, r in zip(ids, got):
            recv[(k, side)] = comm_mod.ring_fixup(
                mesh, r, axis=axis, num_devices=p, side=side)
    outs = []
    for k, (tail, own, head) in enumerate(parts):
        win = [t for t in (recv.get((k, "left")), own,
                           recv.get((k, "right"))) if t is not None]
        win = win[0] if len(win) == 1 else torch.cat(win, dim=2)
        outs.append(win.movedim((0, 1, 2), (rank_dim, stack_dim, lane_dim)))
    return outs


# ---------------------------------------------------------------------------
# Aggregated exchange emitters
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HaloItem:
    """Runtime payload of one scheduled exchange: the resident slab plus
    the static geometry the prior-patch needs (per-axis tuples; rank-1
    items use 1-tuples)."""

    stacks: Any
    chunks: tuple
    shifts: tuple
    prior: Any = None
    bases: tuple = (0,)
    covers: tuple | None = None
    dtype: Any = None


def aggregated_halo_exchange(mesh, items, *, axis: str,
                             num_devices: int) -> list:
    """Rank-1 aggregated exchange: every item's left payloads pack into
    one ``ppermute``, every right payload into another; returns one read
    window per item, identical to per-buffer
    :func:`repro_torch.core.comm.halo_exchange`.  A single-item group
    delegates to it outright."""
    if len(items) == 1:
        it = items[0]
        return [comm_mod.halo_exchange(
            mesh, it.stacks, axis=axis, num_devices=num_devices,
            chunk=it.chunks[0], delta_min=it.shifts[0][0],
            delta_max=it.shifts[0][1], prior=it.prior, base=it.bases[0],
            cover=None if it.covers is None else it.covers[0],
            dtype=it.dtype)]
    wins = _ring_extend_many(
        mesh, [(it.stacks, it.chunks[0], it.shifts[0][0], it.shifts[0][1])
               for it in items], axis=axis, num_devices=num_devices)
    ranks = (mesh.local_ranks(axis).start, num_devices)
    return [comm_mod.patch_window_prior(
        win, chunk=it.chunks[0], delta_min=it.shifts[0][0], prior=it.prior,
        base=it.bases[0], cover=None if it.covers is None else it.covers[0],
        dtype=it.dtype, ranks=ranks) for win, it in zip(wins, items)]


def aggregated_halo_exchange2(mesh, items, *, axes,
                              num_devices) -> list:
    """Rank-2 aggregated exchange: one packed row-ring pass for every
    item, then one packed column-ring pass over the *extended* windows
    (the corner cells ride the second pass, as in
    :func:`repro_torch.core.comm.halo_exchange2`), so a group of 2-D
    stencils costs at most 4 launches."""
    if len(items) == 1:
        it = items[0]
        return [comm_mod.halo_exchange2(
            mesh, it.stacks, axes=axes, num_devices=num_devices,
            chunks=it.chunks, deltas=it.shifts, prior=it.prior,
            bases=it.bases, covers=it.covers, dtype=it.dtype)]
    mine = mesh.local_ranks(axes[0])
    wins = _ring_extend_many(
        mesh, [(it.stacks, it.chunks[0], it.shifts[0][0], it.shifts[0][1])
               for it in items], axis=axes[0], num_devices=num_devices[0],
        dims=(0, 1, 2))
    wins = _ring_extend_many(
        mesh.carrying(axes[0]),
        [(win, it.chunks[1], it.shifts[1][0], it.shifts[1][1])
         for win, it in zip(wins, items)], axis=axes[1],
        num_devices=num_devices[1], dims=(3, 4, 5))
    return [comm_mod.patch_window_prior2(
        win, chunks=it.chunks, deltas=it.shifts, prior=it.prior,
        bases=it.bases, covers=it.covers, dtype=it.dtype,
        ranks=(mine.start, num_devices[0]))
        for win, it in zip(wins, items)]


# ---------------------------------------------------------------------------
# Fused reduction combines
# ---------------------------------------------------------------------------


def fused_collectives(mesh, entries, axis_name):
    """``entries``: ``{path: (collective, per_rank_value)}`` with
    collective in psum/pmax/pmin and per-rank values carrying the leading
    rank dims of ``axis_name``.  Returns ``{path: combined}``."""
    lead = len(axis_name) if isinstance(axis_name, tuple) else 1
    out: dict[Any, Any] = {}
    groups: dict[tuple[str, torch.dtype], list] = {}
    for path, (coll, val) in entries.items():
        groups.setdefault((coll, val.dtype), []).append((path, val))
    for (coll, _), members in groups.items():
        fn = getattr(mesh, coll)
        if len(members) == 1:
            path, val = members[0]
            out[path] = fn(val, axis_name)
            continue
        flats = [v.flatten(lead) if v.dim() > lead else v.unsqueeze(-1)
                 for _, v in members]
        combined = fn(torch.cat(flats, dim=lead), axis_name)
        off = 0
        for (path, val), flat in zip(members, flats):
            n = flat.shape[-1]
            out[path] = combined[off:off + n].reshape(val.shape[lead:])
            off += n
    return out


def fused_cross_device_combine(mesh, items, axis_name):
    """Fused :func:`repro_torch.core.reduction.cross_device_combine`:
    psum/pmax/pmin partials group through :func:`fused_collectives`;
    ``*``/``/`` keep their per-key all-gather fold.  ``items``:
    ``{key: (ReductionOp, per_rank_partial)}``."""
    out = {}
    entries = {}
    for key, (rop, val) in items.items():
        if rop.collective in _FUSABLE:
            entries[key] = (rop.collective, val)
        else:
            out[key] = red_mod.cross_device_combine(mesh, rop, val, axis_name)
    out.update(fused_collectives(mesh, entries, axis_name))
    return out
