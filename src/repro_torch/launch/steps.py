"""Step builders over a mesh — counterpart of :mod:`repro.launch.steps`
(``make_train_cell``, ``make_prefill_cell``, ``make_decode_cell``,
``make_cell``, ``lower_cell``), on the stacked-rank mesh
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
psums, not the reference's HLO collectives.

**Across processes** (:class:`repro_torch.mesh.ProcessMesh`: the first
mesh axis's ranks split over the processes of a ``torch.distributed``
group) the step runs the ranks the process holds: its batch argument is
its own ranks' rows (the global batch is the processes' batches in
process order), the loops go over its local data ranks, the
microbatch's token count is summed over the processes (uncounted: the
stacked mesh sums it in place), and the gradients' and metrics' psums
cross processes, folded in rank order as on the stacked mesh, so every
process ends the step with the stacked step's parameters, state and
metrics bit for bit.  An MoE unit must not span two processes.  The
plan, ``_dp_degree`` and the MoE groups stay global.

**The serve cells** (``make_prefill_cell``, ``make_decode_cell``) lay
out the serve plan (:func:`_serve_plan`): bf16 inference parameters and
bf16 caches are stored as per-rank blocks where their specs shard them
and gathered (counted) before use, the new caches cut back to the
blocks.  Prefill and decode are row by row apart from the MoE dispatch,
whose groups are the data ranks' contiguous rows, so the step runs every
rank's rows in one call over the global batch: each data rank's part of
it is that rank's prefill or decode.  Across processes a process runs
its own data ranks' rows: its batch, tokens and positions are theirs, the
parameters are gathered whole, the caches from the blocks it holds
(:meth:`~repro_torch.mesh.ProcessMesh.unshard_local`), and a sequence
sharded over the data ranks (``shard_seq``) is refused.  The reference's ``donate`` (buffer
donation to XLA) has no counterpart: the step returns new caches and
leaves the caller's as they were.

**Lowering** (:func:`lower_cell`) runs a cell's step once on its
``args``, which are ``meta`` tensors: shapes and dtypes only, nothing
allocated and no kernel run, as the reference's AOT lowering touches no
device memory.  Its record (:class:`Lowered`) holds what the reference
reads off XLA's compiled module, as far as the port has it: the outputs'
shapes, the per-rank argument bytes, the products' FLOPs and the mesh's
collectives.  It is not an XLA ``Lowered``: there is no HLO, no
compiler and no temporary-buffer size.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs import (ModelConfig, ShapeConfig, TrainConfig,
                                 recommended_train_config)
from repro_torch.core import tensor_plan as tp
from repro_torch.models import build_model
from repro_torch.optim import (clip_by_global_norm, cosine_warmup,
                               make_optimizer)
from repro_torch.optim.api import opt_state_axes
from repro_torch.pytree import flatten_with_paths, tree_map, unflatten_like

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


#: per cell kind: the group of each step argument (:class:`Lowered`)
ARG_GROUPS = {"train": ("params", "opt_state", "batch", "batch"),
              "prefill": ("params", "batch", "caches"),
              "decode": ("params", "caches", "batch", "batch")}
#: per cell kind: the step argument :meth:`CellSpec.place` lays out
#: beside the parameters (the optimizer state or the caches)
_STATE_ARG = {"train": 1, "prefill": 2, "decode": 1}


@dataclasses.dataclass
class CellSpec:
    """One step over a mesh: its kind, model, plan and arguments.

    ``kind`` is ``"train"``, ``"prefill"`` or ``"decode"``, and
    ``step_fn`` takes, in this order, ``(params, opt_state, batch,
    step)``, ``(params, batch, caches)`` or ``(params, caches, tokens,
    pos)``.  The parameters and the optimizer state or caches are taken
    and returned as stored on the mesh (per-rank blocks where their spec
    shards them: :meth:`place` lays whole trees out so, :meth:`gather`
    gathers them back); the batch, tokens and positions are the whole
    global ones.  ``args`` are the step's arguments as ``meta`` tensors
    in that layout, the counterpart of the reference's
    ``ShapeDtypeStruct`` tuple, and ``specs`` their spec trees.
    ``init_state(params)`` is what :meth:`place` lays out when it is given
    no state: the optimizer's initial state, or empty caches."""

    kind: str
    mesh: Any
    plan: tp.TensorPlan
    step_fn: Any
    model: Any
    args: tuple
    specs: tuple
    init_state: Any
    optimizer: Any = None
    n_micro: int = 1

    @property
    def param_specs(self):
        return self.specs[0]

    @property
    def state_specs(self):
        """The specs of the optimizer state or of the caches."""
        return self.specs[_STATE_ARG[self.kind]]

    def place(self, params, state=None):
        """(params, state) as the step stores them: every leaf cut into
        its per-rank blocks.  ``state`` (the optimizer state, or the
        caches) defaults to ``init_state(params)``."""
        if state is None:
            state = self.init_state(params)
        return (map_specs(self.mesh.shard, params, self.param_specs),
                map_specs(self.mesh.shard, state, self.state_specs))

    def gather(self, params, state):
        """The whole (params, state) trees (counted gathers)."""
        return (map_specs(self.mesh.unshard, params, self.param_specs),
                map_specs(self.mesh.unshard, state, self.state_specs))


def _dp_degree(mesh) -> int:
    n = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            n *= mesh.shape[a]
    return n


def _batch_fields(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """(field -> (shape, dtype)) of a training batch of this arch."""
    b, s = shape.global_batch, shape.seq_len
    fields = {"labels": ((b, s), torch.int32)}
    if cfg.family == "encdec":
        fields["frames"] = ((b, cfg.encoder.n_frames, cfg.d_model),
                            torch.float32)
        fields["tokens"] = ((b, s), torch.int32)
    elif cfg.embedding_stub:
        fields["embeds"] = ((b, s, cfg.d_model), torch.bfloat16)
    else:
        fields["tokens"] = ((b, s), torch.int32)
    return fields


_BATCH_AXES = {
    "labels": (tp.BATCH, None),
    "tokens": (tp.BATCH, None),
    "frames": (tp.BATCH, None, None),
    "embeds": (tp.BATCH, None, None),
}


def _meta_batch(plan, fields, processes: int = 1):
    """(batch of ``meta`` tensors, its specs) of ``fields``: one
    process's rows of the global batch (the specs are the global
    batch's)."""
    return ({k: torch.empty((sh[0] // processes,) + tuple(sh[1:]),
                            dtype=dt, device="meta")
             for k, (sh, dt) in fields.items()},
            {k: plan.spec(sh, _BATCH_AXES[k])
             for k, (sh, _) in fields.items()})


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
    o_shapes = opt.init(p_shapes)
    opt_specs = plan.tree_specs(o_shapes,
                                opt_state_axes(train_cfg.optimizer, p_shapes,
                                               p_axes))
    b = shape.global_batch
    batch_spec = plan.spec((b, shape.seq_len), (tp.BATCH, None))
    batch_axes = tuple(a for a in tp.spec_axes(batch_spec[0] if batch_spec
                                               else None)
                       if mesh.shape[a] > 1)
    k = math.prod(mesh.shape[a] for a in batch_axes)   # batch shards
    k_loc = math.prod(mesh.local_shape[a] for a in batch_axes)  # held here
    if b % (k * n_micro):
        raise ValueError(f"batch {b} does not split into {k} ranks x "
                         f"{n_micro} microbatches")
    if k_loc * mesh.processes != k:
        raise ValueError(
            f"the batch's rank axes {batch_axes} do not split over the "
            f"{mesh.processes} processes: a process runs the rows of its "
            "own data ranks")
    # units: ranks and MoE groups that overlap run together
    g_eff = moe_groups(groups, b // n_micro) if cfg.moe is not None else k
    n_units = math.gcd(k, g_eff)
    unit_groups = g_eff // n_units
    per_unit = k // n_units
    if k_loc % per_unit:
        raise ValueError(
            f"an MoE unit of {per_unit} ranks (ranks and dispatch groups "
            "that overlap run as one forward) would span two processes, "
            f"each of which holds {k_loc}: the unit's ranks must divide a "
            "process's ranks")
    rows = b // k                                      # a rank's rows

    def shard_act(x):
        return plan.constrain(x, act_axes,
                              shape=(x.shape[0] * n_units,) + x.shape[1:])

    def rank_micro(batch, r, i):
        """Local rank ``r``'s microbatch ``i``: its rows of the process's
        batch, strided."""
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
        grads = [[None] * len(flat) for _ in range(k_loc)]
        stats = torch.zeros((k_loc, 3), dtype=torch.float32,
                            device=leaves_flat[0].device)
        for i in range(n_micro):
            parts = [rank_micro(batch, r, i) for r in range(k_loc)]
            # the microbatch's tokens over every process (not counted:
            # the stacked mesh sums them in place)
            n_tok = mesh.total(sum(_tokens(p) for p in parts))
            n_tok = (torch.clamp(n_tok, min=1.0) if torch.is_tensor(n_tok)
                     else max(n_tok, 1))
            for u in range(k_loc // per_unit):
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
            lead = tuple(mesh.local_shape[a] for a in batch_axes)
            summed = [mesh.psum(torch.stack([
                torch.zeros_like(p) if grads[r][j] is None else grads[r][j]
                for r in range(k_loc)]).reshape(lead + tuple(p.shape)),
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

    batch_args, batch_specs = _meta_batch(plan, _batch_fields(cfg, shape),
                                          mesh.processes)
    args = (map_specs(mesh.shard, p_shapes, param_specs),
            map_specs(mesh.shard, o_shapes, opt_specs), batch_args,
            torch.empty((), dtype=torch.int32, device="meta"))
    return CellSpec("train", mesh, plan, train_step, model, args,
                    (param_specs, opt_specs, batch_specs, tp.P()),
                    opt.init, opt, n_micro)


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------


def _serve_plan(mesh, shape: ShapeConfig) -> tp.TensorPlan:
    """The serve plan of ``shape`` on ``mesh``: the sequence sharded in
    place of the batch when the global batch is smaller than the
    data-parallel degree."""
    shard_seq = shape.global_batch < _dp_degree(mesh)
    return tp.make_serve_plan(mesh.axis_names, tuple(mesh.shape.values()),
                              shard_seq=shard_seq, decode=shape.is_decode)


def _cache_shapes(model, batch: int, cache_len: int):
    """(bf16 caches on the ``meta`` device, their axes tree)."""
    return (model.init_cache(batch, cache_len, dtype=torch.bfloat16,
                             device="meta"), model.cache_axes())


def _serve_cell(cfg, shape, mesh):
    """The parts both serve cells share: (model, plan, MoE groups,
    shard_fn, bf16 parameter shapes and specs, cache shapes and specs,
    the empty caches of a parameter tree)."""
    model = build_model(cfg)
    plan = _serve_plan(mesh, shape)
    dp = _dp_degree(mesh)
    if shape.global_batch < dp and mesh.processes > 1:
        raise ValueError(
            f"a global batch of {shape.global_batch} below the data-"
            f"parallel degree {dp} shards the sequence over the data "
            f"ranks (shard_seq); over {mesh.processes} processes each "
            "would need the others' sequence blocks, which the process "
            "mesh does not exchange")
    groups = 1 if shape.global_batch < dp else dp // mesh.processes

    def shard_act(x):
        # a process holds its data ranks' rows: the spec is the global
        # batch's
        return plan.constrain(x, (tp.BATCH, None, None),
                              shape=(x.shape[0] * mesh.processes,)
                              + tuple(x.shape[1:]))

    p_shapes, p_axes = param_shapes(model, torch.bfloat16)
    c_shapes, c_axes = _cache_shapes(model, shape.global_batch,
                                     shape.seq_len)

    def empty_caches(params):
        leaf = next(iter(flatten_with_paths(params)[1]))
        return model.init_cache(shape.global_batch, shape.seq_len,
                                dtype=torch.bfloat16, device=leaf.device)

    return (model, plan, groups, shard_act, p_shapes,
            plan.tree_specs(p_shapes, p_axes), c_shapes,
            plan.tree_specs(c_shapes, c_axes), empty_caches)


def make_prefill_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                      attn_impl="auto") -> CellSpec:
    """The prefill step of ``cfg`` at ``shape`` over ``mesh``:
    ``step_fn(params, batch, caches) -> (last-token logits, caches)``.

    Parameters are bf16 (inference), stored as blocks where the serve
    plan shards them and gathered before use; caches are bf16, laid out
    by ``model.cache_axes()``, gathered, filled and cut back to their
    blocks; the batch holds the fields of a training batch but
    ``labels``.  MoE ``groups`` is the data-parallel degree, or 1 when
    the batch is smaller than it; ``shard_fn`` constrains the residual
    stream to ``(BATCH, None, None)``.  Compute is bf16."""
    (model, plan, groups, shard_act, p_shapes, param_specs, c_shapes,
     cache_specs, empty_caches) = _serve_cell(cfg, shape, mesh)
    fields = _batch_fields(cfg, shape)
    fields.pop("labels")
    batch_args, batch_specs = _meta_batch(plan, fields, mesh.processes)

    def prefill_step(params, batch, caches):
        logits, new = model.prefill(
            map_specs(mesh.unshard, params, param_specs), batch,
            map_specs(mesh.unshard_local, caches, cache_specs),
            impl=attn_impl, compute_dtype=torch.bfloat16, groups=groups,
            shard_fn=shard_act)
        return logits, map_specs(mesh.shard_local, new, cache_specs)

    args = (map_specs(mesh.shard, p_shapes, param_specs), batch_args,
            map_specs(mesh.shard, c_shapes, cache_specs))
    return CellSpec("prefill", mesh, plan, prefill_step, model, args,
                    (param_specs, batch_specs, cache_specs), empty_caches)


def make_decode_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                     attn_impl="auto") -> CellSpec:
    """The decode step of ``cfg`` at ``shape`` over ``mesh``:
    ``step_fn(params, caches, tokens, pos) -> (logits, caches)`` with
    ``(B,)`` int32 tokens and positions; parameters, caches, groups and
    ``shard_fn`` as :func:`make_prefill_cell` lays them out (the serve
    plan's decode rules)."""
    (model, plan, groups, shard_act, p_shapes, param_specs, c_shapes,
     cache_specs, empty_caches) = _serve_cell(cfg, shape, mesh)
    b = shape.global_batch
    row_spec = plan.spec((b,), (tp.BATCH,))

    def decode_step(params, caches, tokens, pos):
        logits, new = model.decode_step(
            map_specs(mesh.unshard, params, param_specs),
            map_specs(mesh.unshard_local, caches, cache_specs), tokens, pos,
            impl=attn_impl, groups=groups, compute_dtype=torch.bfloat16,
            shard_fn=shard_act)
        return logits, map_specs(mesh.shard_local, new, cache_specs)

    rows = torch.empty((b // mesh.processes,), dtype=torch.int32,
                       device="meta")
    args = (map_specs(mesh.shard, p_shapes, param_specs),
            map_specs(mesh.shard, c_shapes, cache_specs), rows, rows)
    return CellSpec("decode", mesh, plan, decode_step, model, args,
                    (param_specs, cache_specs, row_spec, row_spec),
                    empty_caches)


def make_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
              train_cfg: TrainConfig | None = None, **kw) -> CellSpec:
    """The cell of ``shape.kind``; a train shape without ``train_cfg``
    takes :func:`recommended_train_config`."""
    if shape.kind == "train":
        return make_train_cell(cfg, shape, mesh,
                               train_cfg or recommended_train_config(cfg),
                               **kw)
    if shape.kind == "prefill":
        return make_prefill_cell(cfg, shape, mesh, **kw)
    return make_decode_cell(cfg, shape, mesh, **kw)


# ---------------------------------------------------------------------------
# Lowering on the meta device
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Lowered:
    """What :func:`lower_cell` reads off one run of a cell's step on
    ``meta`` tensors.

    ``outputs``: (path, shape, dtype) of every output leaf.
    ``arg_bytes``: one rank's argument bytes by group (:data:`ARG_GROUPS`:
    params, opt_state, batch, caches), each leaf's bytes over the ranks
    its spec shards it across.  ``flops``: the products' FLOPs
    (``torch.utils.flop_counter``: matrix products and convolutions,
    backward passes included) of the whole step, every rank's rows.
    ``launches``/``bytes``: the mesh's counters by collective; ``calls``:
    one ``(op, group size, one rank's payload bytes)`` per collective
    (:attr:`repro_torch.mesh.Mesh.log`)."""

    kind: str
    outputs: list
    arg_bytes: dict
    flops: float
    launches: dict
    bytes: dict
    calls: list

    @property
    def argument_bytes(self) -> int:
        """One rank's argument bytes, every group."""
        return sum(self.arg_bytes.values())


def _rank_bytes(mesh, leaf, spec) -> int:
    """One rank's bytes of a leaf laid out by ``spec`` (stored whole or
    as blocks: its elements over the ranks the spec names)."""
    k = math.prod(mesh.shape[a] for e in spec for a in tp.spec_axes(e))
    return leaf.numel() * leaf.element_size() // k


def lower_cell(cell: CellSpec) -> Lowered:
    """Run ``cell.step_fn`` once on ``cell.args`` (``meta`` tensors: no
    device memory is touched, no kernel runs) with the mesh's counters
    reset, counting its products' FLOPs; returns the :class:`Lowered`
    record.  A cell built on the card or the CPU lowers alike; one built
    with ``attn_impl="kernel"`` raises, as K2 runs only on the card."""
    from torch.utils.flop_counter import FlopCounterMode

    mesh = cell.mesh
    arg_bytes: dict = {}
    for group, arg, spec in zip(ARG_GROUPS[cell.kind], cell.args,
                                cell.specs):
        per = []
        map_specs(lambda leaf, sp: per.append(_rank_bytes(mesh, leaf, sp)),
                  arg, spec)
        arg_bytes[group] = arg_bytes.get(group, 0) + sum(per)
    mesh.reset_counters()
    mesh.log = calls = []
    try:
        with FlopCounterMode(display=False) as counter:
            out = cell.step_fn(*cell.args)
    finally:
        mesh.log = None
    names, leaves = flatten_with_paths(out)
    return Lowered(
        cell.kind,
        [(n, tuple(x.shape), str(x.dtype).replace("torch.", ""))
         for n, x in zip(names, leaves) if torch.is_tensor(x)],
        arg_bytes, float(counter.get_total_flops()), dict(mesh.launches),
        dict(mesh.bytes), calls)
