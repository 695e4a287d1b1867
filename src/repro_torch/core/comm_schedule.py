"""Fused block combines — the single-block part of the reference's
communication scheduler (:mod:`repro.core.comm_schedule`).

A block's psum-family combines (scatter buffer + mask pairs, put
broadcasts, reduction partials) cross the mesh once per (collective,
dtype) group instead of once per merge: same-group per-rank operands
flatten and concatenate into one stacked vector, one collective runs over
it, and the result splits back.  Elementwise combines commute with
concatenation, so results equal per-operand collectives bit for bit.
The region-wide scheduler (payload aggregation, hoisted exchanges)
belongs to the region slice.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import reduction as red_mod

SCHEDULE_MODES = ("aggregate", "inline")

_FUSABLE = ("psum", "pmax", "pmin")   # Mesh methods of the same names


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
