"""Loop Analysis (paper §3.1.2).

OMP2MPI recovers the canonical semantics of the annotated ``for`` loop —
induction variable, initial value, bound, stride and comparison — and
*rejects* loops it cannot canonicalise (non-linear induction, compound
conditions), leaving them as OpenMP blocks.  Here the loop is already
declared as ``range(start, stop, step)`` on the :class:`ParallelFor`
program, so this stage (a) validates/normalises those bounds and (b)
computes the iteration space used by the scheduler.
"""
from __future__ import annotations

import dataclasses


class LoopNotCanonical(Exception):
    """Raised when the loop cannot be transformed (paper: the block is
    kept as an OpenMP block and executed on the shared-memory node)."""


@dataclasses.dataclass(frozen=True)
class LoopInfo:
    """Canonicalised loop: iteration k in [0, trip_count) maps to
    ``i = start + k * step``."""

    start: int
    stop: int
    step: int
    trip_count: int


def analyze_loop(start: int, stop: int, step: int) -> LoopInfo:
    """Validate and canonicalise the loop bounds.

    Mirrors the paper's checks: the induction must advance by a non-zero
    static stride and the bound must be a single comparison.  Zero strides
    or non-integer bounds are exactly the "complex non-linear increments"
    the paper refuses to transform.
    """
    for name, v in (("start", start), ("stop", stop), ("step", step)):
        if not isinstance(v, int):
            raise LoopNotCanonical(
                f"loop {name} must be a static int, got {type(v).__name__} "
                "(paper §3.1.2: non-canonical loops are kept as OpenMP blocks)"
            )
    if step == 0:
        raise LoopNotCanonical("loop step must be non-zero")
    if step > 0:
        trip = max(0, -(-(stop - start) // step))
    else:
        trip = max(0, -(-(start - stop) // (-step)))
    return LoopInfo(start=start, stop=stop, step=step, trip_count=trip)
