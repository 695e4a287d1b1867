"""Pragma IR — the ``#pragma omp parallel for`` analogue for PyTorch loop
bodies (counterpart of :mod:`repro.core.pragma`).

A :class:`ParallelFor` program wraps a loop *body* plus the clauses the
paper recognises (bounds, ``schedule``, ``reduction``).  The body is a
function ``body(i, env) -> {name: update}`` (``body(i, j, env)`` for a
``collapse(2)`` nest) where ``env`` is a dict of tensors and each update
is one of :func:`at`, :func:`put` or :func:`red`.

Bodies are always evaluated under ``torch.func.vmap`` over lane vectors
of iteration indices, never with a Python or 0-d ``i``: indexing
``env["x"][i]`` with a 0-d index tensor would call ``.item()``.  So the
update wrappers are dataclasses registered with ``torch.utils._pytree``,
which vmap passes through like any container.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch.utils._pytree as pytree


# ---------------------------------------------------------------------------
# Schedule clause
# ---------------------------------------------------------------------------

STATIC = "static"
DYNAMIC = "dynamic"
GUIDED = "guided"

_VALID_SCHEDULES = (STATIC, DYNAMIC, GUIDED)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """``schedule(kind[, chunk])`` clause.

    ``chunk=None`` derives the chunk size the way the paper does:
    * static  -> one contiguous block per rank,
    * dynamic -> ``N / ranks / 10`` (Table 2 line 4 over-decomposition),
    * guided  -> ``N / (2 * ranks)``.
    """

    kind: str = DYNAMIC
    chunk: int | None = None

    def __post_init__(self) -> None:
        if self.kind not in _VALID_SCHEDULES:
            raise ValueError(
                f"schedule kind must be one of {_VALID_SCHEDULES}, got {self.kind!r}"
            )
        if self.chunk is not None and self.chunk < 1:
            raise ValueError(f"schedule chunk must be >= 1, got {self.chunk}")


def static(chunk: int | None = None) -> Schedule:
    return Schedule(STATIC, chunk)


def dynamic(chunk: int | None = None) -> Schedule:
    return Schedule(DYNAMIC, chunk)


def guided(chunk: int | None = None) -> Schedule:
    return Schedule(GUIDED, chunk)


# ---------------------------------------------------------------------------
# Update wrappers (the write side of the dataflow; reads are inferred)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class At:
    """``var[idx] = value`` — idx is (an affine function of) the iterator."""

    idx: Any
    value: Any


@dataclasses.dataclass
class Put:
    """Whole-array write; the array produced by the last iteration wins."""

    value: Any


@dataclasses.dataclass
class Red:
    """Per-iteration contribution to a ``reduction`` clause variable."""

    value: Any


pytree.register_dataclass(At)
pytree.register_dataclass(Put)
pytree.register_dataclass(Red)


def at(idx: Any, value: Any) -> At:
    return At(idx, value)


def put(value: Any) -> Put:
    return Put(value)


def red(value: Any) -> Red:
    return Red(value)


# ---------------------------------------------------------------------------
# ParallelFor program object
# ---------------------------------------------------------------------------


def _axis_bounds(start, stop, step, collapse):
    """Normalise (start, stop, step) clauses to per-axis bound triples."""
    def per_axis(v, default):
        if v is None:
            v = default
        if isinstance(v, (tuple, list)):
            if len(v) != collapse:
                raise ValueError(
                    f"clause {v!r} must have {collapse} entries for "
                    f"collapse={collapse}")
            return tuple(int(e) for e in v)
        return (int(v),) * collapse

    if stop is None:
        raise ValueError("parallel_for requires a static 'stop' bound")
    starts = per_axis(start, 0)
    stops = per_axis(stop, None)
    steps = per_axis(step, 1)
    return tuple(zip(starts, stops, steps))


class ParallelFor:
    """A ``#pragma omp parallel for`` block over a PyTorch body.

    ``collapse=2`` declares a rank-2 nest: ``start``/``stop``/``step``
    accept per-axis tuples and the body takes ``(i, j, env)``.

    Calling the object executes the *shared-memory* ("OpenMP")
    semantics on the env's device — the reference against which the
    distributed program is validated.
    """

    def __init__(
        self,
        body: Callable[..., Mapping[str, Any]],
        *,
        start: int | tuple = 0,
        stop: int | tuple | None = None,
        step: int | tuple = 1,
        collapse: int = 1,
        schedule: Schedule | str | None = None,
        reduction: Mapping[str, str] | None = None,
        name: str | None = None,
    ) -> None:
        if collapse not in (1, 2):
            raise ValueError(f"collapse must be 1 or 2, got {collapse}")
        if collapse == 1 and any(isinstance(v, (tuple, list))
                                 for v in (start, stop, step)):
            raise ValueError(
                "tuple bounds need collapse=2 (the nested-loop form)")
        self.collapse = collapse
        self.bounds = _axis_bounds(start, stop, step, collapse)
        if isinstance(schedule, str):
            schedule = Schedule(schedule)
        self.body = body
        self.start, self.stop, self.step = self.bounds[0]
        self.schedule = schedule or Schedule(DYNAMIC)
        self.reduction = dict(reduction or {})
        self.name = name or getattr(body, "__name__", "parallel_for")

    @property
    def rank(self) -> int:
        return self.collapse

    @property
    def schedules(self) -> tuple[Schedule, ...]:
        """Per-axis schedule clauses (one shared clause)."""
        return (self.schedule,) * self.collapse

    def __call__(self, env: Mapping[str, Any]) -> dict[str, Any]:
        from repro_torch.core import transform as _transform

        return _transform.run_reference(self, env)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        red_s = f", reduction={self.reduction}" if self.reduction else ""
        rngs = " x ".join(f"range({s}, {e}, {t})" for s, e, t in self.bounds)
        return (
            f"ParallelFor({self.name}, {rngs}, "
            f"schedule={self.schedule.kind}{red_s})"
        )


def parallel_for(
    *,
    start: int | tuple = 0,
    stop: int | tuple | None = None,
    step: int | tuple = 1,
    collapse: int = 1,
    schedule: Schedule | str | None = None,
    reduction: Mapping[str, str] | None = None,
    name: str | None = None,
) -> Callable[[Callable], ParallelFor]:
    """Decorator form: ``@omp.parallel_for(stop=N, schedule=omp.dynamic())``
    or, for a rank-2 nest, ``@omp.parallel_for(stop=(N, M), collapse=2)``."""

    def wrap(body: Callable) -> ParallelFor:
        return ParallelFor(
            body,
            start=start,
            stop=stop,
            step=step,
            collapse=collapse,
            schedule=schedule,
            reduction=reduction,
            name=name,
        )

    return wrap


# ---------------------------------------------------------------------------
# ParallelRegion — whole-program container.  Held as data only: compiling a
# region waits for the region slice of the port (omp.compile raises).
# ---------------------------------------------------------------------------


class SerialStage:
    """Pure serial glue between parallel blocks: ``fn(env) -> updates``."""

    def __init__(self, fn: Callable[[Mapping[str, Any]], Mapping[str, Any]],
                 *, reads: tuple[str, ...] | None = None,
                 name: str | None = None) -> None:
        self.fn = fn
        self.reads = tuple(reads) if reads is not None else None
        self.name = name or getattr(fn, "__name__", "serial")

    def __call__(self, env: Mapping[str, Any]) -> dict[str, Any]:
        out = dict(env)
        out.update(self.fn(env))
        return out

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        r = f", reads={list(self.reads)}" if self.reads is not None else ""
        return f"SerialStage({self.name}{r})"


def serial(fn: Callable | None = None, *,
           reads: tuple[str, ...] | None = None,
           name: str | None = None):
    """Wrap serial glue for a :class:`ParallelRegion` (decorator or call)."""
    if fn is not None:
        return SerialStage(fn, reads=reads, name=name)

    def wrap(f: Callable) -> SerialStage:
        return SerialStage(f, reads=reads, name=name)

    return wrap


class ParallelRegion:
    """An ordered sequence of :class:`ParallelFor` blocks and
    :class:`SerialStage` glue.  Calling it runs the shared-memory
    semantics stage by stage."""

    def __init__(self, stages, *, name: str | None = None) -> None:
        stages = tuple(stages)
        if not stages:
            raise ValueError("ParallelRegion needs at least one stage")
        for s in stages:
            if not isinstance(s, (ParallelFor, SerialStage)):
                raise TypeError(
                    "region stages must be ParallelFor or SerialStage, got "
                    f"{type(s).__name__}"
                )
        if not any(isinstance(s, ParallelFor) for s in stages):
            raise ValueError("ParallelRegion needs at least one ParallelFor")
        self.stages = stages
        self.name = name or "region"

    @property
    def loops(self) -> tuple[ParallelFor, ...]:
        return tuple(s for s in self.stages if isinstance(s, ParallelFor))

    @property
    def rank(self) -> int:
        ranks = {lp.rank for lp in self.loops}
        if len(ranks) != 1:
            raise ValueError(
                f"region {self.name!r} mixes nest ranks {sorted(ranks)}; "
                "all loops must share one collapse level")
        return ranks.pop()

    def __call__(self, env: Mapping[str, Any]) -> dict[str, Any]:
        out = dict(env)
        for stage in self.stages:
            out = stage(out)
        return out

    def __iter__(self):
        return iter(self.stages)

    def __len__(self) -> int:
        return len(self.stages)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        inner = ", ".join(s.name for s in self.stages)
        return f"ParallelRegion({self.name}: [{inner}])"


def region(*stages, name: str | None = None) -> ParallelRegion:
    """Build a :class:`ParallelRegion`; accepts stages or one iterable."""
    if len(stages) == 1 and not isinstance(stages[0],
                                           (ParallelFor, SerialStage)):
        stages = tuple(stages[0])
    return ParallelRegion(stages, name=name)
