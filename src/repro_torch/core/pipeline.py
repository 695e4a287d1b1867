"""Pipeline parallelism (GPipe-style) over a mesh axis — counterpart of
:mod:`repro.core.pipeline`, on the stacked-rank mesh
(:class:`repro_torch.mesh.Mesh`).

Stages of a layer stack live on successive ranks of one mesh axis;
microbatches stream through, and activations hop stage -> stage by
``Mesh.ppermute`` — the communication pattern the paper's master/worker
dispatch becomes when the "iterations" are *pipeline slots* instead of
loop chunks.

Design (lockstep, differentiable):

* the stacked stage parameters carry the stage axis as their leading
  rank dim (the mesh's per-rank convention), and the activation buffer
  is per-rank too: ``(S, mb, ...)``;
* every tick runs the stage body on EVERY stage (lockstep, as the
  reference's SPMD program does): one call per stage, in stage order.
  A stage's output is only *consumed* once the wavefront reaches it, so
  the warm-up/drain ticks compute on placeholder data (the standard
  bubble, (S-1)/(M+S-1) of the ticks).  A stage body that launches a
  kernel therefore launches it S x (M+S-1) times per forward pass;
* stage 0 takes microbatch ``min(t, M-1)`` at tick ``t``, the last
  stage emits, and the buffer moves s -> s+1 by one ``ppermute`` per
  tick, so a forward pass counts M+S-1 ``ppermute`` launches;
* ``torch.autograd`` differentiates straight through the ticks and the
  ``ppermute``s (whose gradient is the inverse permutation), and
  ``checkpoint=True`` wraps the stage body in
  ``torch.utils.checkpoint.checkpoint`` (non-reentrant), keeping one
  stage input per tick instead of the body's activations.

:func:`make_pipeline` builds the end-to-end callable.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.pytree import tree_map


def pipeline_apply(stage_fn, stage_params, x_micro, *, mesh, axis: str,
                   num_stages: int, checkpoint: bool = True):
    """Run ``num_stages`` pipeline stages over microbatches.

    stage_fn: (params, x) -> y with x.shape == y.shape (activations hop
      between stages, so stage boundaries share one activation shape).
    stage_params: every stage's parameters, stacked over a leading stage
      dim (rank ``s`` holds stage ``s``).
    x_micro: (M, mb, ...) microbatched input (replicated across stages).

    Returns (M, mb, ...): the last stage's emissions.
    """
    m = x_micro.shape[0]
    ticks = m + num_stages - 1
    perm = [(i, i + 1) for i in range(num_stages - 1)]
    params = [tree_map(lambda t, s=s: t[s], stage_params)
              for s in range(num_stages)]

    def body(p, x):
        if checkpoint:
            return torch.utils.checkpoint.checkpoint(stage_fn, p, x,
                                                     use_reentrant=False)
        return stage_fn(p, x)

    buf = torch.zeros((num_stages,) + tuple(x_micro.shape[1:]),
                      dtype=x_micro.dtype, device=x_micro.device)
    emits = []
    for t in range(ticks):
        # stage 0 ingests microbatch t (clamped during drain)
        cur = [x_micro[min(t, m - 1)]] + [buf[s]
                                           for s in range(1, num_stages)]
        out = torch.stack([body(params[s], cur[s])
                           for s in range(num_stages)])
        # hop to the next stage (rank s -> s+1)
        buf = mesh.ppermute(out, axis, perm)
        # the last stage emits microbatch t - (S-1) at tick t
        if t >= num_stages - 1:
            emits.append(out[num_stages - 1])
    return torch.stack(emits)                   # (M, mb, ...)


def make_pipeline(stage_fn, mesh, *, axis: str, checkpoint: bool = True):
    """End-to-end pipeline over ``axis`` of ``mesh``.

    Returns ``run(stacked_params, x_micro) -> (M, mb, ...)``, where
    ``stacked_params`` has a leading stage dim of the axis's size and
    ``x_micro`` is the (M, mb, ...) microbatched input; the result is the
    last stage's emissions."""
    num_stages = mesh.shape[axis]

    def run(stacked_params, x_micro):
        _check_stages(stacked_params, num_stages)
        return pipeline_apply(stage_fn, stacked_params, x_micro, mesh=mesh,
                              axis=axis, num_stages=num_stages,
                              checkpoint=checkpoint)

    return run


def _check_stages(tree, num_stages):
    if isinstance(tree, dict):
        for v in tree.values():
            _check_stages(v, num_stages)
    elif tree.shape[0] != num_stages:
        raise ValueError(f"stacked stage parameters lead with "
                         f"{tree.shape[0]}, the axis has {num_stages} stages")
