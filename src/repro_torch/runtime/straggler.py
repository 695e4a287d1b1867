"""Straggler detection and mitigation (counterpart of
:mod:`repro.runtime.straggler`).

In lock-step SPMD a slow host stalls every step (the collective waits).
Mitigations available without breaking SPMD semantics:

1. *detect* — per-step wall-time EWMA + spike counting (this module);
2. *re-balance* — the paper's own answer: dynamic-schedule
   over-decomposition.  The pragma engine's cyclic chunking
   (``core/schedule.py``) already deals 10x more chunks than devices, so a
   persistently slow device can be given fewer chunks by regenerating
   the chunk plan with a ``weights`` vector (``rebalance_chunks``);
3. *escalate* — report the host for eviction (elastic re-mesh,
   ``runtime/elastic.py``) once it exceeds the spike budget.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class StragglerMonitor:
    ewma_alpha: float = 0.2
    spike_factor: float = 2.0
    spike_budget: int = 5

    _ewma: float | None = None
    spikes: int = 0
    steps: int = 0

    def observe(self, step_time_s: float) -> str:
        """Returns "ok" | "spike" | "evict"."""
        self.steps += 1
        if self._ewma is None:
            self._ewma = step_time_s
            return "ok"
        status = "ok"
        if step_time_s > self.spike_factor * self._ewma:
            self.spikes += 1
            status = "spike"
            if self.spikes >= self.spike_budget:
                status = "evict"
        else:
            self.spikes = max(0, self.spikes - 1)
        self._ewma = ((1 - self.ewma_alpha) * self._ewma
                      + self.ewma_alpha * step_time_s)
        return status

    @property
    def ewma(self) -> float:
        return self._ewma or 0.0


def rebalance_chunks(num_chunks: int, weights: list[float]) -> list[int]:
    """Deal ``num_chunks`` cyclic chunks proportionally to per-device
    speed ``weights`` (higher = faster = more chunks).  Returns the
    device owner of each chunk — the straggler-aware replacement for
    ``chunk j -> device j % P``.

    Quotas are assigned by largest-remainder apportionment, which
    always sums exactly to ``num_chunks`` and so terminates for every
    input — including ``num_chunks < len(weights)``, where the slowest
    devices simply receive zero chunks.  When there are at least as
    many chunks as devices, every device receives at least one chunk
    (SPMD lock-step means an idle device still pays for the step; a
    zero quota would only waste its slot).
    """
    if num_chunks < 1:
        raise ValueError(f"num_chunks must be >= 1, got {num_chunks}")
    p = len(weights)
    if p == 0:
        raise ValueError("weights must be non-empty")
    for w in weights:
        if not math.isfinite(w) or w <= 0:
            raise ValueError(
                f"weights must be finite and > 0, got {list(weights)}")
    total = float(sum(weights))
    ideal = [num_chunks * w / total for w in weights]
    quota = [int(f) for f in (math.floor(x) for x in ideal)]
    if num_chunks >= p:
        quota = [max(1, q) for q in quota]
    # Largest-remainder repair: hand out (or claw back) the rounding
    # drift one chunk at a time, fastest-first, never below the floor.
    floor = 1 if num_chunks >= p else 0
    drift = num_chunks - sum(quota)
    order = sorted(range(p), key=lambda i: (-(ideal[i] - quota[i]), i))
    i = 0
    while drift > 0:
        quota[order[i % p]] += 1
        drift -= 1
        i += 1
    order = sorted(range(p), key=lambda i: (ideal[i] - quota[i], i))
    i = 0
    while drift < 0:
        d = order[i % p]
        if quota[d] > floor:
            quota[d] -= 1
            drift += 1
        i += 1
    owners: list[int] = []
    remaining = quota[:]
    dev = 0
    for _ in range(num_chunks):
        while remaining[dev % p] == 0:
            dev += 1
        owners.append(dev % p)
        remaining[dev % p] -= 1
        dev += 1
    return owners
