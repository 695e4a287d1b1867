"""Elastic re-mesh planning and re-placement (counterpart of
:mod:`repro.runtime.elastic`).

When the set of ranks shrinks (eviction, a lost device), the program
restarts on a new mesh.  ``plan_elastic_remesh`` picks the nearest valid
(data, model) factoring for the new rank count; ``reshard_tree``
re-places a tree for the new mesh.  The port's mesh stacks its virtual
ranks on one device and keeps a replicated tensor as one shared tensor,
so re-placing is moving every leaf to the mesh's device.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    old_shape: tuple[int, ...]
    new_shape: tuple[int, ...]
    axes: tuple[str, ...]
    note: str


def plan_elastic_remesh(n_devices: int, *, model_parallel: int,
                        axes=("data", "model")) -> RemeshPlan:
    """Keep model-parallel degree fixed (it is tied to the weight layout
    budget), flex the data axis; shrink TP only if chips < TP."""
    tp = model_parallel
    note = ""
    while n_devices % tp != 0 or n_devices < tp:
        tp //= 2
        note = f"model axis shrunk to {tp} (chip count {n_devices})"
        if tp == 0:
            raise ValueError("no valid mesh factoring")
    dp = n_devices // tp
    return RemeshPlan(old_shape=(-1, model_parallel),
                      new_shape=(dp, tp), axes=tuple(axes), note=note)


def reshard_tree(tree, mesh):
    """Re-place every tensor leaf of ``tree`` replicated on ``mesh``: one
    shared tensor on the mesh's device (other leaves pass through)."""
    return torch.utils._pytree.tree_map(
        lambda x: x.to(mesh.device) if isinstance(x, torch.Tensor) else x,
        tree)
