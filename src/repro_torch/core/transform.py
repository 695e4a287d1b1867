"""OMP→"MPI" code generation for one block (paper §3.1.3–3.1.4) —
counterpart of :mod:`repro.core.transform`.

* :func:`run_reference` — the *shared-memory* ("OpenMP") semantics: the
  body vmapped over every iteration at once.  This is the oracle.
* :class:`DistributedProgram` (built by the **lower** pass of
  :func:`repro_torch.core.api.compile`) — executes the block over the
  stacked-rank mesh (:mod:`repro_torch.mesh`) with the
  :class:`~repro_torch.core.plan.DistPlan` strategies, as the reference's
  ``shard_map`` program does, in two phases:

  - **compute**: every rank's chunks evaluate the body on their lanes —
    ``vmap`` over ranks, then over local chunks, then over lanes
    (:func:`lane_values`), or the span kernel under ``Lowering.KERNEL``
    (:mod:`repro_torch.core.kernel_lower`) — and fold into per-rank
    partials (``merge_chunk_values``);
  - **combine**: the psum-family merges cross the mesh
    (:func:`~repro_torch.core.comm_schedule.fused_collectives`), and the
    chunk-cyclic slabs reassemble to the shared-memory layout.

The master/worker lowering waits for a later slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch
from torch.func import vmap

from repro_torch import convert
from repro_torch.core import comm_schedule as cs_mod
from repro_torch.core import kernel_lower as kl
from repro_torch.core import nest as nest_mod
from repro_torch.core import pragma, reduction as red_mod
from repro_torch.core import context as ctx_mod
from repro_torch.core.context import lane_body, vmap_lanes
from repro_torch.core.loop import LoopNotCanonical
from repro_torch.core.nest import LoopNest, ShiftedWindow, clamp_if_sliced
from repro_torch.core.plan import DistPlan


def env_device(env: Mapping[str, Any]) -> torch.device:
    """The device an env lives on: that of its first tensor (CPU for an
    env of Python values)."""
    for v in env.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def _fresh_reduction_shapes(program, env, nest):
    """Value shape/dtype of each reduction output not yet in ``env``."""
    fresh = [k for k in program.reduction if k not in env]
    if not fresh:
        return {}
    ctx = ctx_mod.analyze_context(program, env, nest)
    return {k: (ctx.vars[k].write.value_shape, ctx.vars[k].write.value_dtype)
            for k in fresh if k in ctx.vars}


# ---------------------------------------------------------------------------
# Shared-memory reference executor ("the OpenMP block")
# ---------------------------------------------------------------------------


def run_reference(program: pragma.ParallelFor, env: Mapping[str, Any]) -> dict:
    """Execute with OpenMP shared-memory semantics on the env's device.

    Reads observe the pre-loop environment (iterations are concurrent in
    OpenMP; racy read-after-write across iterations is unsupported).  A
    sliced read past either end of an array reads it as ``jnp`` indexing
    does (negative wraps once, then clamps: :class:`ClampedArray`).  A
    zero-trip loop writes nothing, except that a reduction clause
    defines its variable as the op identity.
    """
    device = env_device(env)
    env = {k: convert.to_tensor(v, device) for k, v in env.items()}
    nest = LoopNest.from_program(program)
    out = dict(env)
    if nest.total_trip == 0:
        for key, (shape, dtype) in _fresh_reduction_shapes(
                program, env, nest).items():
            rop = red_mod.get_reduction(program.reduction[key])
            out[key] = torch.full(shape, red_mod.identity_value(rop, dtype),
                                  dtype=dtype, device=device)
        return out

    ivecs = tuple(
        (ax.start + ax.step * torch.arange(ax.trip_count, dtype=torch.int32,
                                           device=device)).to(torch.int32)
        for ax in nest.axes)
    ctx = ctx_mod.analyze_context(program, env, nest)
    reads = {k: clamp_if_sliced(v, ctx.vars[k].read) for k, v in env.items()}
    updates = vmap_lanes(lane_body(program, nest.rank), nest.rank, ivecs,
                         reads)
    fold_dims = tuple(range(nest.rank))
    for key, upd in updates.items():
        if isinstance(upd, pragma.At):
            idx = upd.idx if isinstance(upd.idx, tuple) else (upd.idx,)
            idx = tuple(torch.as_tensor(ix).long() for ix in idx)
            out[key] = out[key].index_put(idx, upd.value.to(out[key].dtype))
        elif isinstance(upd, pragma.Put) and nest.rank == 1:
            out[key] = upd.value[nest.total_trip - 1]
        elif isinstance(upd, pragma.Red):
            rop = red_mod.get_reduction(program.reduction[key])
            folded = rop.local_fold(upd.value, fold_dims)
            if key in env:
                folded = rop.pairwise(env[key], folded)
            out[key] = folded
        else:
            raise LoopNotCanonical(
                f"update for {key!r} must be omp.at/omp.put/omp.red"
                + (" (omp.at/omp.red in a collapse=2 nest)"
                   if nest.rank == 2 else ""))
    return out


# ---------------------------------------------------------------------------
# Distributed program
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DistributedProgram:
    """The generated "MPI" program for one parallel block."""

    program: pragma.ParallelFor
    mesh: Any
    plan: DistPlan
    comm_schedule: str = "aggregate"    # fuse per-block combines when set
    use_kernel: bool = False            # Lowering.KERNEL: the span kernel
    kernel_plan: Any = None             # its KernelPlan (spans + source)

    def __call__(self, env: Mapping[str, Any]) -> dict:
        return _execute(self, check_env(env, self.mesh.device))

    def report(self) -> str:
        from repro_torch.core import report as report_mod

        return report_mod.render_plan(self.plan)


def check_env(env: Mapping[str, Any], device: torch.device) -> dict:
    """Env values as tensors on the mesh device; a tensor that lies on
    another device is an error, never silently moved."""
    out = {}
    for k, v in env.items():
        if isinstance(v, torch.Tensor):
            if v.device.type != device.type or (
                    device.index is not None and v.device.index is not None
                    and v.device.index != device.index):
                raise ValueError(
                    f"env[{k!r}] lies on {v.device}, the mesh on {device}; "
                    "move the env to the mesh's device first")
            out[k] = v
        else:
            out[k] = convert.to_tensor(v, device)
    return out


def resolve_axes(program_or_rank, mesh, axis):
    """Resolve the mesh-axis clause against the program's nest rank:
    ``(axis, num_devices)``, scalars for rank 1 and 2-tuples for rank 2
    (default ``("i", "j")`` when present, else the first two axes)."""
    rank = (program_or_rank if isinstance(program_or_rank, int)
            else program_or_rank.rank)
    names = tuple(mesh.axis_names)
    if rank == 2:
        if axis is None:
            if "i" in names and "j" in names:
                axis = ("i", "j")
            elif len(names) >= 2:
                axis = names[:2]
            else:
                raise ValueError(
                    f"collapse=2 needs a 2-D mesh; got axes {names}")
        if not isinstance(axis, tuple) or len(axis) != 2 \
                or axis[0] == axis[1]:
            raise ValueError(
                f"collapse=2 needs two distinct mesh axes, got {axis!r}")
        for a in axis:
            if a not in names:
                raise ValueError(f"axis {a!r} not in mesh axes {names}")
        return axis, tuple(int(mesh.shape[a]) for a in axis)
    if axis is None:
        axis = "data"
    if axis not in names:
        raise ValueError(f"axis {axis!r} not in mesh axes {names}")
    return axis, mesh.shape[axis]


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------


def _execute(dp: DistributedProgram, env: dict) -> dict:
    plan = dp.plan
    out = dict(env)
    if plan.nest.total_trip == 0:
        for key, dec in plan.vars.items():
            if dec.out_strategy == "reduce":
                rop = red_mod.get_reduction(dec.reduction_op)
                w = plan.context.vars[key].write
                zero = torch.full(w.value_shape,
                                  red_mod.identity_value(rop, w.value_dtype),
                                  dtype=w.value_dtype, device=dp.mesh.device)
                out[key] = rop.pairwise(env[key], zero) if key in env else zero
        return out
    if plan.rank == 2:
        return _execute_collective2(dp, env)
    return _execute_collective(dp, env)


def _lane_iterations(ch, loop, device):
    """Slot table plus every lane's loop index, ``(n_loc, P, c)`` int32;
    masked lanes (k >= trip) clamp to the last iteration."""
    js, ks = nest_mod.slot_iterations(ch, device)
    kc = ks.clamp(max=max(0, loop.trip_count - 1))
    return js, (loop.start + loop.step * kc).to(torch.int32)


def _env_sub(plan, env_in, wins, offs, device):
    env_sub = {}
    for key in plan.context.env_keys:
        dec = plan.vars[key]
        info = plan.context.vars[key]
        if key in wins:
            env_sub[key] = ShiftedWindow(wins[key], offs[key], info.shape,
                                         info.dtype)
        elif dec.in_strategy == "replicate":
            env_sub[key] = clamp_if_sliced(env_in[key], info.read)
        else:   # never read: the right shape at no memory (zero strides)
            env_sub[key] = torch.zeros((), dtype=info.dtype,
                                       device=device).expand(info.shape)
    return env_sub


def lane_values(plan, program, env_in, slab_stacks, device) -> dict:
    """Dense per-lane body values of every rank's chunks, in the global
    slab layout ``(n_loc, P, c, *value_shape)`` (rank 1) — the plain
    PyTorch evaluation that the span kernel computes in one launch.

    ``slab_stacks`` hold the sharded inputs as ``(n_loc, P, w, *rest)``
    windows; ``env_in`` the replicated ones.  vmap runs over ranks
    (dim 1), then over local chunks (skipped when each rank has one:
    the static fast path), then over lanes.
    """
    ch, loop = plan.chunks, plan.loop
    js, ivec = _lane_iterations(ch, loop, device)
    offs = {k: (js * ch.chunk + plan.vars[k].window()[0]).to(torch.int32)
            for k in slab_stacks}
    fn = lane_body(program, 1)
    keys = plan.written_keys

    def chunk(iv, wins, off):
        env_sub = _env_sub(plan, env_in, wins,
                           {k: (o,) for k, o in off.items()}, device)
        upd = vmap_lanes(fn, 1, (iv,), env_sub)
        return {k: upd[k].value for k in keys}

    def rank(iv, wins, off):
        if ch.local_chunks == 1:
            got = chunk(iv[0], {k: w[0] for k, w in wins.items()},
                        {k: o[0] for k, o in off.items()})
            return {k: v[None] for k, v in got.items()}
        return vmap(chunk)(iv, wins, off)

    return vmap(rank, in_dims=1, out_dims=1)(ivec, dict(slab_stacks), offs)


def lane_values2(plan, program, env_in, slab_stacks, device) -> dict:
    """Rank-2 :func:`lane_values`: ``(n_i, P_i, c_i, n_j, P_j, c_j, *v)``.

    Sharded inputs are ``(n_i, P_i, w_i, n_j, P_j, w_j, *rest)`` windows
    (``shard_ndim == 2``) or ``(n_i, P_i, w_i, *rest)`` (``== 1``)."""
    ch_i, ch_j = plan.chunks_axes
    loop_i, loop_j = plan.nest.axes
    js_i, ivec = _lane_iterations(ch_i, loop_i, device)
    js_j, jvec = _lane_iterations(ch_j, loop_j, device)
    w2 = {k: v for k, v in slab_stacks.items() if plan.vars[k].shard_ndim == 2}
    w1 = {k: v for k, v in slab_stacks.items() if k not in w2}
    oi = {k: (js_i * ch_i.chunk + plan.vars[k].window(0)[0]).to(torch.int32)
          for k in slab_stacks}
    oj = {k: (js_j * ch_j.chunk + plan.vars[k].window(1)[0]).to(torch.int32)
          for k in w2}
    fn = lane_body(program, 2)
    keys = plan.written_keys

    def pair(iv, jv, w2, w1, oi, oj):
        wins = {**w2, **w1}
        offs = {k: (oi[k], oj[k]) if k in oj else (oi[k],) for k in wins}
        upd = vmap_lanes(fn, 2, (iv, jv),
                         _env_sub(plan, env_in, wins, offs, device))
        return {k: upd[k].value for k in keys}

    def pairs(iv, jv, w2, w1, oi, oj):
        if ch_i.local_chunks * ch_j.local_chunks == 1:
            got = pair(iv[0], jv[0], {k: w[0, :, 0] for k, w in w2.items()},
                       {k: w[0] for k, w in w1.items()},
                       {k: o[0] for k, o in oi.items()},
                       {k: o[0] for k, o in oj.items()})
            return {k: v[None, :, None] for k, v in got.items()}
        inner = vmap(pair, in_dims=(None, 0, 1, None, None, 0), out_dims=1)
        return vmap(inner, in_dims=(0, None, 0, 0, 0, None))(
            iv, jv, w2, w1, oi, oj)

    over_pj = vmap(pairs, in_dims=(None, 1, 3, None, None, 1), out_dims=3)
    over_pi = vmap(over_pj, in_dims=(1, None, 1, 1, 1, None), out_dims=1)
    return over_pi(ivec, jvec, w2, w1, oi, oj)


def _run_local_chunks(plan, program, env_in, slab_stacks, device):
    """Every rank's chunks, plain PyTorch: per-rank ``(carry, ys)`` —
    ``ys`` dense values in the global slab layout, ``carry`` the
    scatter/put/reduce partials with a leading rank dim."""
    return kl.merge_chunk_values(
        plan, lane_values(plan, program, env_in, slab_stacks, device))


def _run_local_chunks2(plan, program, env_in, slab_stacks, device):
    """Rank-2 :func:`_run_local_chunks` (partials lead with (P_i, P_j))."""
    return kl.merge_chunk_values2(
        plan, lane_values2(plan, program, env_in, slab_stacks, device))


def stage_inputs(plan, env):
    """The compute phase's inputs: ``(replicated, slabs)`` — replicated
    buffers as they are, sharded ones staged into chunk-cyclic windows
    (the data distribution the reference's ``shard_map`` in_specs do)."""
    repl = {k: env[k] for k in plan.replicated_in_keys}
    slabs = {}
    for k in plan.sharded_in_keys:
        dec = plan.vars[k]
        if plan.rank == 2:
            if dec.shard_ndim == 2:
                slabs[k] = nest_mod.halo_slabs2(env[k], plan.chunks_axes,
                                                dec.halo_axes)
            else:
                slabs[k] = nest_mod.halo_slabs(env[k], plan.chunks_axes[0],
                                               dec.halo_axes[0])
        elif dec.in_strategy == "shard_halo":
            slabs[k] = nest_mod.halo_slabs(env[k], plan.chunks, dec.halo)
        else:
            slabs[k] = nest_mod.pad_reshape(env[k], plan.chunks)
    return repl, slabs


def _compute(dp, env):
    plan, program, device = dp.plan, dp.program, dp.mesh.device
    env_repl, env_slab = stage_inputs(plan, env)
    if dp.use_kernel:
        return kl.run_local_chunks_kernel(plan, program, env_repl, env_slab,
                                          dp.kernel_plan, device)
    run = _run_local_chunks if plan.rank == 1 else _run_local_chunks2
    return run(plan, program, env_repl, env_slab, device)


def _combine(mesh, entries, axis, aggregate: bool):
    if aggregate:
        return cs_mod.fused_collectives(mesh, entries, axis)
    return {path: getattr(mesh, coll)(val, axis) for path, (coll, val)
            in entries.items()}


def _execute_collective(dp: DistributedProgram, env: dict) -> dict:
    plan, mesh = dp.plan, dp.mesh
    axis, ch = plan.axis, plan.chunks
    t = plan.loop.trip_count
    carry, ys = _compute(dp, env)

    # combine phase: every psum-family merge of the block defers into one
    # fused collective per (collective, dtype) group with the aggregate
    # schedule, one launch per merge with "inline"
    d = mesh.axis_index(axis)
    pending: dict[tuple[str, str], tuple[str, Any]] = {}
    gathered: dict[str, torch.Tensor] = {}
    for key, dec in plan.vars.items():
        if dec.out_strategy == "scatter":
            buf, mask = carry[key]
            pending[(key, "buf")] = ("psum", buf)
            pending[(key, "mask")] = ("psum", mask.to(torch.int32))
        elif dec.out_strategy == "put":
            owner = ch.owner_of_last_iteration()
            val = carry[key]
            sel = (d == owner).reshape((-1,) + (1,) * (val.dim() - 1))
            pending[(key, "put")] = ("psum", torch.where(
                sel, val, torch.zeros_like(val)))
        elif dec.out_strategy == "reduce":
            rop = red_mod.get_reduction(dec.reduction_op)
            if rop.collective == "gather":
                gathered[key] = mesh.all_gather(carry[key], axis)
            else:
                pending[(key, "red")] = (rop.collective, carry[key])
    combined = (_combine(mesh, pending, axis, dp.comm_schedule == "aggregate")
                if pending else {})

    # reassembly (layout, not messages)
    result = dict(env)
    for key, dec in plan.vars.items():
        if dec.out_strategy in ("identity", "partial"):
            flat = nest_mod.unpad_flat(ys[key], ch, t).to(env[key].dtype)
            if dec.out_strategy == "identity":
                result[key] = flat
            else:
                b = dec.write_map.b
                result[key] = env[key].clone()
                result[key][b:b + t] = flat
        elif dec.out_strategy == "scatter":
            summed = combined[(key, "buf")]
            mask = combined[(key, "mask")]
            vmask = (mask > 0).reshape((-1,) + (1,) * (summed.dim() - 1))
            result[key] = torch.where(vmask, summed.to(env[key].dtype),
                                      env[key])
        elif dec.out_strategy == "put":
            result[key] = combined[(key, "put")]
        elif dec.out_strategy == "reduce":
            rop = red_mod.get_reduction(dec.reduction_op)
            if key in gathered:
                val = rop.local_fold(gathered[key], 0)
            else:
                val = combined[(key, "red")]
            if key in env:
                val = rop.pairwise(env[key], val)
            result[key] = val
    return result


def _execute_collective2(dp: DistributedProgram, env: dict) -> dict:
    plan, mesh = dp.plan, dp.mesh
    axes = tuple(plan.axes_names)
    chs = plan.chunks_axes
    trips = plan.nest.trip_counts
    carry, ys = _compute(dp, env)

    items = {key: (red_mod.get_reduction(dec.reduction_op), carry[key])
             for key, dec in plan.vars.items()
             if dec.out_strategy == "reduce"}
    if dp.comm_schedule == "aggregate":
        combined = cs_mod.fused_cross_device_combine(mesh, items, axes)
    else:
        combined = {key: red_mod.cross_device_combine(mesh, rop, val, axes)
                    for key, (rop, val) in items.items()}

    result = dict(env)
    for key, dec in plan.vars.items():
        if dec.out_strategy in ("identity", "partial"):
            flat = nest_mod.unpad_flat2(ys[key], chs, trips).to(
                env[key].dtype)
            if dec.out_strategy == "identity":
                result[key] = flat
            else:
                bi, bj = dec.write_maps[0].b, dec.write_maps[1].b
                result[key] = env[key].clone()
                result[key][bi:bi + trips[0], bj:bj + trips[1]] = flat
        elif dec.out_strategy == "reduce":
            rop = red_mod.get_reduction(dec.reduction_op)
            val = combined[key]
            if key in env:
                val = rop.pairwise(env[key], val)
            result[key] = val
    return result
