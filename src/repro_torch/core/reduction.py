"""Reduction clause lowering (paper §3.1.3, Table 3).

The reduction variable starts at the operation's identity (0 for
``+``/``-``, 1 for ``*``/``/``, the dtype's extreme for ``max``/``min``);
chunk partials fold locally and cross ranks with the matching collective
(``psum``/``pmax``/``pmin``; ``*`` has no all-reduce, so partials are
all-gathered and folded — P scalars, negligible traffic).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class ReductionOp:
    name: str
    identity: float
    local_fold: Callable[[Any, Any], Any]     # fold an axis (or axes) of partials
    pairwise: Callable[[Any, Any], Any]       # combine two partials
    collective: str                           # "psum" | "pmax" | "pmin" | "gather"


def _dims(axis) -> tuple[int, ...]:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _fold_sum(x, axis):
    return torch.sum(x, dim=_dims(axis))


def _fold_prod(x, axis):
    dims = _dims(axis)
    if len(dims) > 1:
        x = torch.movedim(x, dims, tuple(range(len(dims)))).flatten(
            0, len(dims) - 1)
        return torch.prod(x, dim=0)
    return torch.prod(x, dim=dims[0])


def _fold_max(x, axis):
    return torch.amax(x, dim=_dims(axis))


def _fold_min(x, axis):
    return torch.amin(x, dim=_dims(axis))


_REDUCTIONS: dict[str, ReductionOp] = {
    "+": ReductionOp("+", 0.0, _fold_sum, lambda a, b: a + b, "psum"),
    "-": ReductionOp("-", 0.0, _fold_sum, lambda a, b: a + b, "psum"),
    "*": ReductionOp("*", 1.0, _fold_prod, lambda a, b: a * b, "gather"),
    "/": ReductionOp("/", 1.0, _fold_prod, lambda a, b: a * b, "gather"),
    "max": ReductionOp("max", -math.inf, _fold_max, torch.maximum, "pmax"),
    "min": ReductionOp("min", math.inf, _fold_min, torch.minimum, "pmin"),
}


def get_reduction(op: str) -> ReductionOp:
    try:
        return _REDUCTIONS[op]
    except KeyError:
        raise ValueError(
            f"unsupported reduction op {op!r}; supported: {sorted(_REDUCTIONS)}"
        ) from None


def identity_value(op: ReductionOp, dtype: torch.dtype):
    """The identity as a Python number for ``dtype`` (``iinfo`` extremes
    for integer max/min, where infinity does not exist)."""
    if op.name in ("max", "min") and not (dtype.is_floating_point
                                          or dtype.is_complex):
        if dtype == torch.bool:
            return op.name == "min"
        info = torch.iinfo(dtype)
        return info.min if op.name == "max" else info.max
    return op.identity


def identity_like(op: ReductionOp, value: torch.Tensor) -> torch.Tensor:
    """Identity element broadcast to ``value``'s shape/dtype/device."""
    return torch.full(value.shape, identity_value(op, value.dtype),
                      dtype=value.dtype, device=value.device)


def cross_device_combine(mesh, op: ReductionOp, partial: torch.Tensor,
                         axis_name):
    """Combine per-rank partials (leading rank dims over ``axis_name``:
    one mesh axis, or a tuple of axes for a 2-D mesh) into one
    replicated value."""
    if op.collective != "gather":      # psum/pmax/pmin: Mesh methods
        return getattr(mesh, op.collective)(partial, axis_name)
    # '*' (and '/'): all-gather the partials and fold locally, one axis
    # at a time (each gather leaves the next axis leading).
    names = axis_name if isinstance(axis_name, tuple) else (axis_name,)
    out = partial
    for nm in names:
        out = op.local_fold(mesh.all_gather(out, nm), 0)
    return out
