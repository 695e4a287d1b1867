"""Mesh definitions — counterpart of :mod:`repro.launch.mesh`, on the
port's stacked-rank mesh (:class:`repro_torch.mesh.Mesh`).

``make_production_mesh`` lays the production layouts out on the
``meta`` device (no memory is allocated): they are for planning and
shape audits.  ``make_local_mesh`` stacks ``ranks`` virtual ranks on one
device — the counterpart of the reference's mesh over ``jax.devices()``
(whose tests set the device count with ``XLA_FLAGS``).
``make_process_mesh`` spreads the same layout over the processes of a
``torch.distributed`` group — the counterpart of the reference's mesh
over every process's devices after ``jax.distributed.initialize``.
"""
from __future__ import annotations

import torch

from repro_torch.mesh import Mesh, ProcessMesh, make_mesh, make_process_mesh as _process_mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single pod (256 ranks) or 2x16x16 multi-pod (512 ranks),
    on the ``meta`` device."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, torch.device("meta"))


def make_local_mesh(model_parallel: int = 1, *, ranks: int | None = None,
                    device=None) -> Mesh:
    """``(ranks // model_parallel, model_parallel)`` over ``("data",
    "model")``: ``ranks`` (default ``model_parallel``) virtual ranks
    stacked on ``device`` (``None``: the CUDA card, raising when there is
    none)."""
    n = model_parallel if ranks is None else ranks
    assert n % model_parallel == 0, (n, model_parallel)
    return make_mesh((n // model_parallel, model_parallel),
                     ("data", "model"), device=device)


def make_process_mesh(model_parallel: int = 1, *, ranks: int | None = None,
                      group=None, device=None) -> ProcessMesh:
    """``(ranks // model_parallel, model_parallel)`` over ``("data",
    "model")``, its ``data`` ranks split over the processes of ``group``
    (default: the world; a contiguous block of them a process), on
    ``device`` (``None``: the CUDA card)."""
    n = model_parallel if ranks is None else ranks
    assert n % model_parallel == 0, (n, model_parallel)
    return _process_mesh((n // model_parallel, model_parallel),
                         ("data", "model"), device=device, group=group)
