"""Workload Distribution — chunking math (paper §3.1.3).

The paper splits the iteration space into chunks and deals them to worker
ranks.  ``schedule(dynamic)`` (the default) over-decomposes by 10x —
``partSize = N / (size-1) / 10`` (Table 2, line 4) — so slow workers get
fewer chunks; ``schedule(static)`` deals one contiguous block per rank in
round-robin; ``guided`` starts large and shrinks.

SPMD adaptation: there is no demand-driven dispatch, so
every schedule becomes a *deterministic chunk→device assignment*:

* static (no chunk): one contiguous block per device,
* static (chunk=c) / dynamic / guided: cyclic assignment — chunk ``j``
  lands on device ``j % P`` so each device sees a representative sample of
  the iteration space (same load-balancing effect the 10x split buys).

Cyclic assignment of equal-size chunks has a crucial structural property:
the global iteration space padded to ``K' * c`` (K' a multiple of P)
reshapes to ``(K'/P, P, c)`` whose *middle axis is the device axis* — so a
"chunk-distributed write" is just an array sharded on that axis, and the
whole master/worker exchange of the paper becomes layout, not messages.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import pragma
from repro_torch.core.loop import LoopInfo
from repro_torch.runtime.straggler import rebalance_chunks


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """Deterministic chunk→device assignment for one parallel block.

    Iteration ``k`` (in ``[0, trip_count)``) lives in chunk ``k // chunk``;
    chunk ``j`` is executed by device ``j % num_devices`` as its local
    chunk number ``j // num_devices``.

    With a per-device ``weights`` vector (straggler mitigation,
    :func:`rebalance_chunks`) the cyclic deal is replaced by a proportional
    one: ``owners[j]`` names the device that executes real chunk ``j``,
    and ``slot_map[q * P + d]`` records which global chunk device ``d``
    runs as its local chunk ``q`` (the *slot* layout that the staging
    reshape ``(n_loc, P, c)`` realises).  Slots a device does not fill
    hold a sentinel chunk index ``>= ceil(trip/chunk)`` whose
    iterations all fall beyond ``trip_count`` and are masked out like
    ordinary padding.  ``owners``/``slot_map`` are ``None`` for the
    plain cyclic deal.
    """

    trip_count: int
    num_devices: int
    chunk: int                 # c — iterations per chunk
    num_chunks: int            # K' — padded to a multiple of num_devices
    local_chunks: int          # n_loc = K' / P
    padded_trip: int           # K' * c >= trip_count
    owners: tuple[int, ...] | None = None     # device owning real chunk j
    slot_map: tuple[int, ...] | None = None   # slot q*P+d -> global chunk
    weights: tuple[float, ...] | None = None  # per-device speed weights

    @property
    def padding(self) -> int:
        return self.padded_trip - self.trip_count

    @property
    def real_chunks(self) -> int:
        """Chunks that hold at least one real iteration."""
        return max(1, -(-self.trip_count // self.chunk))

    def owner_of_iteration(self, k: int) -> int:
        j = k // self.chunk
        if self.owners is not None:
            return self.owners[j]
        return j % self.num_devices

    def owner_of_last_iteration(self) -> int:
        if self.trip_count == 0:
            return 0
        return self.owner_of_iteration(self.trip_count - 1)


def paper_chunk_size(trip_count: int, ranks: int, *,
                     master_excluded: bool = False) -> int:
    """The paper's Table 2 line 4: ``partSize = N / (size-1) / 10``.

    ``master_excluded=True`` reproduces the MPI formula exactly (rank 0
    does not compute); the SPMD variant uses all P devices.
    """
    workers = max(1, ranks - 1 if master_excluded else ranks)
    return max(1, trip_count // workers // 10)


def guided_chunk_size(trip_count: int, ranks: int) -> int:
    """Flattened guided schedule: first-round guided chunk N/(2P)."""
    return max(1, trip_count // max(1, 2 * ranks))


def make_nest_chunk_plans(nest, schedules, num_devices,
                          weights=None) -> tuple[ChunkPlan, ...]:
    """Per-axis chunk plans for a loop nest: axis ``d`` of the iteration
    space is dealt over ``num_devices[d]`` mesh ranks with its own
    schedule clause — the ``collapse(2)`` generalisation of the paper's
    single ``partSize`` split (each axis keeps the Table 2 chunking math
    against its own trip count and rank count).  ``weights`` is an
    optional per-axis sequence of per-device weight vectors (``None``
    entries keep the cyclic deal on that axis)."""
    if not (len(nest.axes) == len(schedules) == len(num_devices)):
        raise ValueError(
            f"nest rank {len(nest.axes)} needs matching schedules "
            f"({len(schedules)}) and device counts ({len(num_devices)})")
    if weights is None:
        weights = (None,) * len(nest.axes)
    if len(weights) != len(nest.axes):
        raise ValueError(
            f"nest rank {len(nest.axes)} needs one weight vector per "
            f"axis, got {len(weights)}")
    return tuple(
        make_chunk_plan(loop_d, sched_d, int(p_d), weights=w_d)
        for loop_d, sched_d, p_d, w_d
        in zip(nest.axes, schedules, num_devices, weights))


def make_chunk_plan(
    loop: LoopInfo,
    schedule: pragma.Schedule,
    num_devices: int,
    *,
    paper_master_excluded: bool = False,
    weights=None,
) -> ChunkPlan:
    t = loop.trip_count
    p = max(1, num_devices)
    if schedule.chunk is not None:
        c = schedule.chunk
    elif schedule.kind == pragma.STATIC:
        c = max(1, -(-t // p))  # one block per device
    elif schedule.kind == pragma.DYNAMIC:
        c = paper_chunk_size(t, p, master_excluded=paper_master_excluded)
    elif schedule.kind == pragma.GUIDED:
        c = guided_chunk_size(t, p)
    else:  # pragma: no cover - Schedule validates kinds
        raise ValueError(schedule.kind)
    c = max(1, min(c, max(1, t)))
    k = max(1, -(-t // c))          # chunks needed
    if weights is None:
        k_pad = -(-k // p) * p      # padded to multiple of P
        return ChunkPlan(
            trip_count=t,
            num_devices=p,
            chunk=c,
            num_chunks=k_pad,
            local_chunks=k_pad // p,
            padded_trip=k_pad * c,
        )
    # Straggler-weighted deal: rebalance_chunks apportions the k real
    # chunks proportionally to per-device speed; the slot layout pads
    # every device to the *maximum* quota so the (n_loc, P, c) staging
    # reshape keeps its shape-uniformity (SPMD devices share one
    # program), with sentinel chunks filling unowned slots.
    w = tuple(float(x) for x in weights)
    if len(w) != p:
        raise ValueError(
            f"weights length {len(w)} != num_devices {p}")
    owners = rebalance_chunks(k, list(w))
    quota = [0] * p
    for d in owners:
        quota[d] += 1
    n_loc = max(1, max(quota))
    num_slots = n_loc * p
    sentinel = k                   # first padding chunk (< num_slots
    per_dev: list[list[int]] = [[] for _ in range(p)]  # whenever used)
    for j, d in enumerate(owners):
        per_dev[d].append(j)
    slot_map: list[int] = []
    for q in range(n_loc):
        for d in range(p):
            slot_map.append(per_dev[d][q] if q < quota[d] else sentinel)
    return ChunkPlan(
        trip_count=t,
        num_devices=p,
        chunk=c,
        num_chunks=num_slots,
        local_chunks=n_loc,
        padded_trip=num_slots * c,
        owners=tuple(owners),
        slot_map=tuple(slot_map),
        weights=w,
    )
