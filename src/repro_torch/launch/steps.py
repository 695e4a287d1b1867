"""The train step over a mesh — counterpart of
:func:`repro.launch.steps.make_train_cell`, on the stacked-rank mesh
(:class:`repro_torch.mesh.Mesh`: every rank on one device).

The plan is the tensor planner's (:func:`repro_torch.core.tensor_plan.
make_train_plan`), and the step lays the work out as it says:

* **Data parallelism.** The batch's ``BATCH`` spec gives each data rank
  a contiguous block of rows, as ``NamedSharding`` lays them out.  Each
  rank differentiates its part of the loss with ``torch.autograd``: its
  tokens' cross-entropy summed over the global batch's token count
  (``loss_fn(tokens=)``; the reference's CE is one masked mean over the
  whole batch) plus its share of the MoE aux loss.  The per-rank gradients are summed
  by ``Mesh.psum`` over the batch axes, so the step's loss, metrics and
  gradients are the reference's global-batch step's.  ``microbatch``
  splits each rank's rows strided, as the reference splits the global
  batch: microbatch ``i`` of the global batch is every rank's microbatch
  ``i``.
* **MoE groups.** ``groups`` is the data-parallel degree (``pod`` x
  ``data``), and the reference forms its dispatch groups over the global
  (micro)batch as contiguous blocks of rows.  Ranks and groups that
  overlap are run together as one *unit* (the ``gcd`` of the rank and
  group counts gives the units): under ``dp_tp`` a rank's rows are
  exactly one group; where a group spans ranks (``dp_only``, whose batch
  also splits over ``model``), the unit's forward is one call whose
  loss comes back per rank (``loss_fn(parts=)``), and each rank's
  gradient is taken from its own part.
* **ZeRO-3 and model-axis shards.** A parameter or optimizer-state leaf
  whose spec maps a dim to a mesh axis is stored as that axis's per-rank
  blocks (:meth:`Mesh.shard`), gathered (counted ``all_gather``) before
  the forward pass; after the psum its gradient is cut back to the
  blocks.  An optimizer whose update is elementwise
  (``Optimizer.elementwise``: AdamW) updates each block; Adafactor's
  factored moments and update clipping reduce over whole dims, so its
  leaves are gathered, updated whole and cut back, and its update is the
  reference's.
* **Activation constraints.** ``shard_fn`` calls ``plan.constrain`` on
  the residual stream where the reference's step constrains it, with the
  global shape, so the divisibility checks run where the reference
  places them.

What the stacked mesh does not do: it does not split a product's
arithmetic across model ranks.  GSPMD's tensor parallelism is XLA's
partitioner, and PyTorch on one device has no counterpart to it.  A
``model``-mapped dim is a storage shard, gathered before use, so
``--model-parallel N`` computes the reference's numbers with another set
of collectives: the mesh's counted bytes are those of the gathers and
psums, not the reference's HLO collectives.  Runs across processes need
the ``torch.distributed`` backend (:data:`DISTRIBUTED`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core import tensor_plan as tp
from repro_torch.models import build_model
from repro_torch.optim import (clip_by_global_norm, cosine_warmup,
                               make_optimizer)
from repro_torch.optim.api import opt_state_axes
from repro_torch.pytree import flatten_with_paths, tree_map, unflatten_like

#: What a run across processes needs (named by the refusals).
DISTRIBUTED = "the torch.distributed backend for Mesh (ROADMAP.md §1)"


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the ``meta`` device (shapes only,
    no memory)."""

    @property
    def device(self):
        return torch.device("meta")


def param_shapes(model, dtype=torch.float32):
    """(parameter tree on the ``meta`` device, axes tree): the shapes
    without allocating the parameters."""
    return model.init(_MetaGenerator(), dtype=dtype)


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its twin spec tree (whose
    leaves are tuples, which :func:`repro_torch.pytree.tree_map` would
    walk into)."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, tree[k], specs[k]) for k in tree}
    return fn(tree, specs)


@dataclasses.dataclass
class CellSpec:
    """A train step over a mesh, its model, optimizer and plan.

    ``step_fn(params, opt_state, batch, step)`` takes and returns the
    parameters and optimizer state as stored on the mesh (per-rank blocks
    where their spec shards them: :meth:`place` lays whole trees out so,
    :meth:`gather` gathers them back) and the whole global batch."""

    mesh: Any
    plan: tp.TensorPlan
    step_fn: Any
    model: Any
    optimizer: Any
    n_micro: int
    param_specs: Any
    opt_specs: Any

    def place(self, params, opt_state=None):
        """(params, opt_state) as the step stores them: every leaf cut
        into its per-rank blocks.  ``opt_state`` defaults to the
        optimizer's initial state of ``params``."""
        if opt_state is None:
            opt_state = self.optimizer.init(params)
        return (map_specs(self.mesh.shard, params, self.param_specs),
                map_specs(self.mesh.shard, opt_state, self.opt_specs))

    def gather(self, params, opt_state):
        """The whole (params, opt_state) trees (counted gathers)."""
        return (map_specs(self.mesh.unshard, params, self.param_specs),
                map_specs(self.mesh.unshard, opt_state, self.opt_specs))


def _dp_degree(mesh) -> int:
    n = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            n *= mesh.shape[a]
    return n


def moe_groups(groups: int, rows: int) -> int:
    """The dispatch groups ``moe_apply`` forms over ``rows`` rows."""
    g = max(1, min(groups, rows))
    return g if rows % g == 0 else 1


def choose_microbatch(cfg: ModelConfig, shape: ShapeConfig,
                      dp: int, *, budget_gb: float = 3.0) -> int:
    """Split the per-device batch so rematerialised activations fit.

    Rough per-microbatch activation estimate: one (B_loc, S, d_model)
    residual per layer in bf16, x4 for block intermediates kept live
    during the rematerialised backward."""
    b_loc = max(1, shape.global_batch // dp)
    per_seq = shape.seq_len * cfg.d_model * 2 * 4 * cfg.n_layers
    micro = 1
    while (b_loc // micro > 1
           and b_loc % (micro * 2) == 0
           and b_loc // micro * per_seq > budget_gb * 2**30):
        micro *= 2
    return micro


def _tokens(batch):
    """The tokens the loss counts (the labels past the first position,
    where the mask keeps them): an int, or a float32 scalar tensor where
    a mask decides."""
    mask = batch.get("mask")
    if mask is None:
        return batch["labels"][:, 1:].numel()
    return mask[:, 1:].float().sum()


def make_train_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    train_cfg: TrainConfig, *, attn_impl="auto") -> CellSpec:
    """The train step of ``cfg`` at ``shape`` over ``mesh`` (a (1, 1)
    mesh gives the one-rank step)."""
    model = build_model(cfg)
    plan = tp.make_train_plan(mesh.axis_names, tuple(mesh.shape.values()),
                              zero3=train_cfg.zero3,
                              strategy=train_cfg.strategy)
    opt = make_optimizer(train_cfg.optimizer,
                         weight_decay=train_cfg.weight_decay)
    groups = _dp_degree(mesh)
    compute_dtype = (torch.bfloat16 if train_cfg.compute_dtype == "bfloat16"
                     else torch.float32)
    n_micro = train_cfg.microbatch or choose_microbatch(cfg, shape, groups)
    act_axes = ((tp.BATCH, tp.SEQ, None) if train_cfg.seq_parallel
                else (tp.BATCH, None, None))
    if train_cfg.seq_parallel:
        plan = dataclasses.replace(
            plan, rules={**plan.rules, tp.SEQ: ("model",)})

    p_shapes, p_axes = param_shapes(model, getattr(torch,
                                                   train_cfg.param_dtype))
    param_specs = plan.tree_specs(p_shapes, p_axes)
    opt_specs = plan.tree_specs(opt.init(p_shapes),
                                opt_state_axes(train_cfg.optimizer, p_shapes,
                                               p_axes))
    b = shape.global_batch
    batch_spec = plan.spec((b, shape.seq_len), (tp.BATCH, None))
    batch_axes = tuple(a for a in tp.spec_axes(batch_spec[0] if batch_spec
                                               else None)
                       if mesh.shape[a] > 1)
    k = math.prod(mesh.shape[a] for a in batch_axes)   # batch shards
    if b % (k * n_micro):
        raise ValueError(f"batch {b} does not split into {k} ranks x "
                         f"{n_micro} microbatches")
    # units: ranks and MoE groups that overlap run together
    g_eff = moe_groups(groups, b // n_micro) if cfg.moe is not None else k
    n_units = math.gcd(k, g_eff)
    unit_groups = g_eff // n_units
    per_unit = k // n_units
    rows = b // k                                      # a rank's rows

    def shard_act(x):
        return plan.constrain(x, act_axes,
                              shape=(x.shape[0] * n_units,) + x.shape[1:])

    def rank_micro(batch, r, i):
        """Rank ``r``'s microbatch ``i``: its rows, strided."""
        def part(x):
            x = x[r * rows:(r + 1) * rows]
            if n_micro == 1:
                return x
            return x.reshape((rows // n_micro, n_micro)
                             + x.shape[1:]).transpose(0, 1)[i]
        return {key: part(x) for key, x in batch.items()}

    def train_step(params, opt_state, batch, step):
        full = map_specs(mesh.unshard, params, param_specs)
        _, flat = flatten_with_paths(full)
        leaves_flat = [p.detach().requires_grad_(True) for p in flat]
        leaves = unflatten_like(full, leaves_flat)
        grads = [[None] * len(flat) for _ in range(k)]
        stats = torch.zeros((k, 3), dtype=torch.float32,
                            device=leaves_flat[0].device)
        for i in range(n_micro):
            parts = [rank_micro(batch, r, i) for r in range(k)]
            n_tok = sum(_tokens(p) for p in parts)
            n_tok = (torch.clamp(n_tok, min=1.0) if torch.is_tensor(n_tok)
                     else max(n_tok, 1))
            for u in range(n_units):
                ranks = range(u * per_unit, (u + 1) * per_unit)
                ub = {key: torch.cat([parts[r][key] for r in ranks])
                      for key in parts[0]}
                # each rank's share of the microbatch's loss: its tokens'
                # CE over the microbatch's token count, and its part of
                # the unit's aux term (the units' auxes are averaged)
                loss, m = model.loss_fn(
                    leaves, ub, impl=attn_impl, groups=unit_groups,
                    remat=train_cfg.remat, compute_dtype=compute_dtype,
                    shard_fn=shard_act, parts=per_unit,
                    tokens=n_tok / n_units)
                shares = torch.stack([loss, m["ce"], m["aux"]], 1) / n_units
                for j, r in enumerate(ranks):
                    gs = torch.autograd.grad(
                        shares[j, 0] / n_micro, leaves_flat,
                        retain_graph=j + 1 < per_unit, allow_unused=True)
                    grads[r] = [g if a is None else (a if g is None else a + g)
                                for a, g in zip(grads[r], gs)]
                    stats[r] += shares[j].detach()
        if k > 1:
            lead = tuple(mesh.shape[a] for a in batch_axes)
            summed = [mesh.psum(torch.stack([
                torch.zeros_like(p) if grads[r][j] is None else grads[r][j]
                for r in range(k)]).reshape(lead + tuple(p.shape)),
                batch_axes) for j, p in enumerate(flat)]
            stats = mesh.psum(stats.reshape(lead + (3,)), batch_axes)
        else:
            summed = [torch.zeros_like(p) if g is None else g
                      for g, p in zip(grads[0], flat)]
            stats = stats[0]
        grads = unflatten_like(full, summed)
        if n_micro > 1:
            loss = stats[0] / n_micro
            metrics = {"ce": loss, "aux": stats[2] / n_micro}
        else:
            loss = stats[0]
            metrics = {"ce": stats[1], "aux": stats[2]}
        grads, gnorm = clip_by_global_norm(grads, train_cfg.grad_clip)
        lr = cosine_warmup(step, base_lr=train_cfg.learning_rate,
                           warmup_steps=train_cfg.warmup_steps,
                           total_steps=train_cfg.total_steps).to(loss.device)
        if not opt.elementwise:
            new_p, new_s = opt.update(
                grads, map_specs(mesh.unshard, opt_state, opt_specs),
                tree_map(torch.Tensor.detach, full), lr)
            params = map_specs(mesh.shard, new_p, param_specs)
            opt_state = map_specs(mesh.shard, new_s, opt_specs)
        else:
            params, opt_state = opt.update(
                map_specs(mesh.shard, grads, param_specs), opt_state,
                params, lr)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm,
                                       lr=lr)

    return CellSpec(mesh, plan, train_step, model, opt, n_micro,
                    param_specs, opt_specs)
