"""The train step across ranks in the PyTorch port on the CPU, held
against the JAX package: ``make_train_cell`` on stacked meshes of 2 and 4
ranks ((2, 1), (2, 2), (4, 1); ZeRO-3 on and off, ``dp_tp`` and
``dp_only``, AdamW and Adafactor, ``microbatch=2``, with and without a
mask) for the smoke gemma3-1b, mamba2-130m and qwen2-moe configs at 1
layer: two steps equal the reference's two steps on a one-device mesh,
built with ``groups`` = the mesh's data-parallel degree for the MoE
config (the reference's own ``make_train_cell``, its ``_dp_degree``
bound to that degree while the cell is built).  Each reference step is
compiled once per (arch, optimizer) and shared by the cases.  Tolerances: metrics rtol 1e-5; parameters and optimizer state
rtol = atol = 1e-4 (MoE 2e-4: capacity slots see float sums in another
order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_dist_train import (B, FAST_COMPILE, KW, LAYERS, S,
                                         _batch, _initial_state, _setup)
from tests.test_torch_train import _tree_close

#: per reference step (arch, optimizer, MoE groups, masked): the port's
#: (mesh shape, zero3, strategy) cases held against it ("+sp": with
#: seq_parallel, whose constraints shard the sequence over "model")
CASES = {
    ("gemma3-1b", "adamw", 1, True): [
        ((2, 1), False, "dp_tp"), ((2, 2), True, "dp_tp"),
        ((4, 1), True, "dp_tp"), ((2, 2), False, "dp_only"),
        ((2, 2), True, "dp_tp+sp")],
    ("mamba2-130m", "adafactor", 1, True): [
        ((2, 1), False, "dp_tp"), ((2, 2), True, "dp_tp"),
        ((4, 1), True, "dp_tp")],
    # MoE groups = the data-parallel degree, 2: one group a rank on
    # (2, 1) and (2, 2) under dp_tp; under dp_only the batch splits over
    # both axes, so each group spans two ranks.  (4, 1), one group a rank
    # too, runs the (2, 1) case's code at another degree, and would cost
    # a reference compile of its own.
    ("qwen2-moe-a2.7b", "adamw", 2, False): [
        ((2, 1), False, "dp_tp"), ((2, 2), True, "dp_tp"),
        ((2, 2), False, "dp_only")],
}


@functools.lru_cache(maxsize=None)
def _reference_steps(arch, opt_name, dp, masked):
    """Two steps (3 and 4) of the reference's train step on a one-device
    mesh, its MoE ``groups`` set to ``dp``: ((params, state, metrics)
    after each step) as numpy."""
    import repro.launch.steps as jsteps
    from repro.configs import ShapeConfig, TrainConfig
    from repro.launch.mesh import make_local_mesh

    jmodel, jparams, _, _ = _setup(arch, LAYERS)
    old = jsteps._dp_degree
    jsteps._dp_degree = lambda mesh: dp
    try:
        cell = jsteps.make_train_cell(
            jmodel.cfg, ShapeConfig("t", S, B, "train"), make_local_mesh(1),
            TrainConfig(optimizer=opt_name, **KW))
    finally:
        jsteps._dp_degree = old
    batch = {k: jnp.asarray(v)
             for k, v in _batch(jmodel.cfg, B, 5, masked).items()}
    params, state = jparams, _initial_state(opt_name, jparams)
    # compiled once: jit would compile again for the committed outputs
    step = jax.jit(cell.step_fn).lower(params, state, batch, jnp.int32(
        3)).compile(compiler_options=FAST_COMPILE)
    out = []
    for i in (3, 4):
        params, state, m = step(params, state, batch, jnp.int32(i))
        out.append(jax.tree_util.tree_map(np.asarray, (params, state, m)))
    return out


@pytest.mark.parametrize("key", list(CASES),
                         ids=lambda k: "-".join(map(str, k)))
def test_train_step_across_ranks_matches_reference(key):
    """Every mesh case of ``key`` against its reference step."""
    want = _reference_steps(*key)
    for shape, zero3, strategy in CASES[key]:
        _hold_case(key, want, shape, zero3, strategy)


def _hold_case(key, want, shape, zero3, strategy):
    from repro_torch import convert
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_train_cell

    arch, opt_name, _, masked = key
    label = f"{shape} zero3={zero3} {strategy}"
    _, jparams, model, params = _setup(arch, LAYERS)
    mesh = make_local_mesh(shape[1], ranks=shape[0] * shape[1],
                           device="cpu")
    cell = make_train_cell(model.cfg, ShapeConfig("t", S, B, "train"), mesh,
                           TrainConfig(optimizer=opt_name, zero3=zero3,
                                       strategy=strategy.split("+")[0],
                                       seq_parallel=strategy.endswith("+sp"),
                                       **KW))
    state = convert.params_from_numpy(jax.tree_util.tree_map(
        np.asarray, _initial_state(opt_name, jparams)), "cpu")
    p, s = cell.place(params, state)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(model.cfg, B, 5, masked).items()}
    tol = 2e-4 if model.cfg.moe is not None else 1e-4
    for i, (wp, ws, wm) in zip((3, 4), want):
        p, s, m = cell.step_fn(p, s, batch, i)
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(wm[k]), rtol=1e-5,
                                       atol=1e-7,
                                       err_msg=f"{label} step {i} {k}")
        gp, gs = cell.gather(p, s)
        _tree_close(gp, wp, tol, f"{label} step {i} params")
        _tree_close(convert.tree_to_numpy(gs), ws, tol,
                    f"{label} step {i} state")
    # the layout: sharded leaves lead with their rank dims; the gradients
    # went through psum over the batch axes, the gathers were counted
    if zero3 or shape[1] > 1:
        assert mesh.launches["all_gather"] > 0, label
        assert any(a.dim() > b.dim() for a, b in zip(
            jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(params)))
    assert mesh.launches["psum"] > 0, label
    assert cell.plan.constrained.total() > 0, label
    if strategy.endswith("+sp"):
        assert set(cell.plan.constrained) == {("data", "model")}, label
