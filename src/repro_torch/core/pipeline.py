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
* stage 0 takes microbatch ``min(t, M-1)`` at tick ``t`` (a ``where``
  over its received buffer, as the reference's ``jnp.where``), the last
  stage emits, and the buffer moves s -> s+1 by one ``ppermute`` per
  tick, so a forward pass counts M+S-1 ``ppermute`` launches;
* over a :class:`~repro_torch.mesh.ProcessMesh` split along ``axis`` a
  process runs the stages it holds (``mesh.local_ranks(axis)``), its
  stage parameters lead with those, and the emissions are read from the
  last stage's process on every process (``mesh.take``, the reference's
  ``out_specs=P(axis)`` row).  The ``where`` keeps every received
  buffer in the graph, so each ``ppermute``'s backward runs at both of
  its ends;
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
    stage_params: the parameters of the stages this process holds (every
      stage on a stacked mesh), stacked over a leading stage dim (rank
      ``s`` holds stage ``s``).
    x_micro: (M, mb, ...) microbatched input (replicated across stages).

    Returns (M, mb, ...): the last stage's emissions.
    """
    m = x_micro.shape[0]
    ticks = m + num_stages - 1
    perm = [(i, i + 1) for i in range(num_stages - 1)]
    stages = mesh.local_ranks(axis)
    params = [tree_map(lambda t, s=s: t[s], stage_params)
              for s in range(len(stages))]
    first = torch.ones((), dtype=torch.bool, device=x_micro.device)

    def body(p, x):
        if checkpoint:
            return torch.utils.checkpoint.checkpoint(stage_fn, p, x,
                                                     use_reentrant=False)
        return stage_fn(p, x)

    buf = torch.zeros((len(stages),) + tuple(x_micro.shape[1:]),
                      dtype=x_micro.dtype, device=x_micro.device)
    outs = []
    for t in range(ticks):
        # stage 0 ingests microbatch t (clamped during drain)
        feed = x_micro[min(t, m - 1)]
        cur = [torch.where(first, feed, buf[i]) if s == 0 else buf[i]
               for i, s in enumerate(stages)]
        out = torch.stack([body(params[i], cur[i])
                           for i in range(len(stages))])
        # hop to the next stage (rank s -> s+1)
        buf = mesh.ppermute(out, axis, perm)
        # the last stage emits microbatch t - (S-1) at tick t
        if t >= num_stages - 1:
            outs.append(out)
    return mesh.take(torch.stack(outs, 1), axis,
                     num_stages - 1)            # (M, mb, ...)


def make_pipeline(stage_fn, mesh, *, axis: str, checkpoint: bool = True):
    """End-to-end pipeline over ``axis`` of ``mesh``.

    Returns ``run(stacked_params, x_micro) -> (M, mb, ...)``, where
    ``stacked_params`` has a leading stage dim of the stages the process
    holds (the axis's size on a stacked mesh) and
    ``x_micro`` is the (M, mb, ...) microbatched input; the result is the
    last stage's emissions."""
    num_stages = mesh.shape[axis]

    def run(stacked_params, x_micro):
        _check_stages(stacked_params, len(mesh.local_ranks(axis)))
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
