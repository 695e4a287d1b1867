"""Training across ranks in the PyTorch port on the CPU, held against the
JAX package, all in-process:

* MoE dispatch groups through the model stack: ``loss_fn(groups=2)`` and
  its gradients on qwen2-moe's and jamba's smoke configs at a batch of 4
  equal the reference's, and differ from ``groups=1`` (tokens drop over
  capacity at both groupings);
* ``compressed_allreduce_tree`` over 4 stacked ranks equals the
  reference's ``_compressed_allreduce_leaf`` under ``jax.vmap`` with a
  named axis, and counts fewer bytes than a float ``psum``;
* ``loss_fn(parts=, tokens=)``: the per-rank shares a train step
  differentiates add up to the whole batch's loss and gradients;
* a sharded run's checkpoint restores into an unsharded cell and back.

``tests/test_torch_dist_step.py`` holds ``make_train_cell`` across ranks
against the reference's step, ``tests/test_torch_data_ckpt.py`` runs
``launch/train.py --model-parallel`` and the ``train_lm`` example.
Tolerances: losses rtol 1e-5 (MoE gradients 2e-4); the all-reduce's
means rtol 1e-6, atol 1e-7 and its errors atol 1e-6 (XLA's fused
arithmetic under ``jax.jit``; a quantisation step is ~1e-2); the shares
rtol 1e-5, atol 1e-7.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_train import _tree_close

B, S = 8, 16
#: one layer (two for jamba, whose first is an SSM layer): the
#: reference's compiles take seconds a layer
LAYERS = 1
#: XLA's compile options for the reference's jitted functions: at these
#: sizes compiling, not running, takes the time; without LLVM's
#: optimisation passes and with the older loop emitters for fusions it
#: takes a third as long (the same step to within 2e-9 here)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_cpu_use_fusion_emitters": False}
ARCHS = ("gemma3-1b", "qwen2-moe-a2.7b", "mamba2-130m",
         "jamba-1.5-large-398b")


@functools.lru_cache(maxsize=None)
def _setup(arch, n_layers):
    """(jax model, jax params, port model, port params): ``arch``'s smoke
    config at ``n_layers`` layers, the same weights drawn with numpy into
    both (norms 0, the rest normal(0, 0.05))."""
    from repro.configs import smoke_config as jsmoke_config
    from repro.models import build_model as jbuild_model
    from repro_torch import convert
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model

    jcfg = dataclasses.replace(jsmoke_config(arch), n_layers=n_layers)
    cfg = dataclasses.replace(smoke_config(arch), n_layers=n_layers)
    jmodel = jbuild_model(jcfg)
    shapes = jax.eval_shape(lambda k: jmodel.init(k)[0],
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(ARCHS.index(arch))
    np_params = jax.tree_util.tree_map_with_path(
        lambda path, s: np.zeros(s.shape, np.float32)
        if "norm" in jax.tree_util.keystr(path)
        else (rng.normal(size=s.shape) * 0.05).astype(np.float32), shapes)
    return (jmodel, jax.tree_util.tree_map(jnp.asarray, np_params),
            build_model(cfg), convert.params_from_numpy(np_params, "cpu"))


def _batch(cfg, b, seed, masked):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, size=(b, S)).astype(np.int32)
    batch = {"tokens": tokens, "labels": tokens}
    if masked:
        batch["mask"] = rng.random((b, S)) < 0.7
    return batch


KW = dict(microbatch=2, compute_dtype="float32", remat=False,
          warmup_steps=2, total_steps=10, learning_rate=1e-2)


def _initial_state(opt_name, jparams):
    from repro.optim import make_optimizer

    state = make_optimizer(opt_name).init(jparams)
    if opt_name == "adamw":
        # a second moment already filled (at 0, Adam's first update is
        # lr * g / (|g| + eps), which a gradient near eps moves anywhere)
        state = dict(state, v=jax.tree_util.tree_map(
            lambda p: jnp.full(p.shape, 1e-2, jnp.float32), jparams))
    return state


def _port_loss_and_grads(model, params, batch, reduce=False, **kw):
    """``loss_fn``'s loss, metrics and gradients (``reduce``: of the sum
    of its per-part losses)."""
    leaves = jax.tree_util.tree_map(lambda p: p.detach().requires_grad_(),
                                    params)
    loss, m = model.loss_fn(leaves, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, **kw)
    if reduce:
        loss = loss.sum()
    loss.backward()
    return (loss.detach(), {k: v.detach() for k, v in m.items()},
            jax.tree_util.tree_map(lambda p: p.grad, leaves))


# ---------------------------------------------------------------------------
# Part A: MoE groups through the model stack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,layers", [("qwen2-moe-a2.7b", 1),
                                         ("jamba-1.5-large-398b", 2)])
def test_moe_groups_reach_the_dispatch(arch, layers):
    """``loss_fn(groups=2)`` and its gradients equal the reference's at a
    batch of 4; the value differs from ``groups=1``, at which (as at 2)
    the router drops tokens over capacity.  qwen2-moe's every layer is
    MoE; jamba's second (after an SSM layer)."""
    from repro_torch.models import moe

    jmodel, jparams, model, params = _setup(arch, layers)
    batch = _batch(model.cfg, 4, 3, masked=False)
    kw = dict(compute_dtype=jnp.float32, impl="full")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, _), wgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jb, groups=2, **kw), has_aux=True)).lower(
        jparams).compile(compiler_options=FAST_COMPILE)(jparams)
    moe.ROUTES = []
    try:
        got, _, grads = _port_loss_and_grads(
            model, params, batch, groups=2, impl="full",
            compute_dtype=torch.float32)
        two = [r.numpy() for r in moe.ROUTES]
        moe.ROUTES = []
        one, _, _ = _port_loss_and_grads(model, params, batch, groups=1,
                                         impl="full",
                                         compute_dtype=torch.float32)
        ones = [r.numpy() for r in moe.ROUTES]
    finally:
        moe.ROUTES = None
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    _tree_close(grads, jax.tree_util.tree_map(np.asarray, wgrads), 2e-4,
                "grads")
    assert two[0].shape[0] == 2 and ones[0].shape[0] == 1
    assert any((r == 1).any() for r in two) and any((r == 1).any()
                                                    for r in ones)
    assert abs(float(got) - float(one)) > 1e-4, (float(got), float(one))


# ---------------------------------------------------------------------------
# The compressed all-reduce
# ---------------------------------------------------------------------------


def test_compressed_allreduce_matches_reference_under_vmap():
    """P = 4 over a leaf of 10 (which P does not divide: padded) and a
    (3, 8) leaf: the means and the new errors equal the reference's
    two-hop int8 mean under ``jax.vmap(..., axis_name="d")``; one
    ``all_to_all`` and three ``all_gather`` a leaf, fewer bytes than a
    float ``psum`` of the same gradients."""
    from repro.optim.grad import _compressed_allreduce_leaf as jleaf
    from repro_torch.mesh import make_mesh
    from repro_torch.optim import compressed_allreduce_tree

    p = 4
    rng = np.random.default_rng(0)
    g = {"a": rng.normal(size=(p, 10)), "b": rng.normal(size=(p, 3, 8))}
    e = {k: rng.normal(size=v.shape) * 0.01 for k, v in g.items()}
    g, e = ({k: v.astype(np.float32) for k, v in t.items()} for t in (g, e))
    mesh = make_mesh((p,), ("d",), device="cpu")
    means, errs = compressed_allreduce_tree(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in e.items()}, mesh=mesh, axis="d")
    for k in g:
        wm, we = jax.jit(jax.vmap(lambda gg, ee: jleaf(gg, ee, "d", p),
                                  axis_name="d"))(g[k], e[k])
        np.testing.assert_allclose(np.broadcast_to(means[k].numpy(),
                                                   wm.shape), wm,
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(errs[k].numpy(), np.asarray(we),
                                   rtol=1e-6, atol=1e-6)
    assert mesh.launches == {"all_to_all": 2, "all_gather": 6}
    compressed = sum(mesh.bytes.values())
    mesh.reset_counters()
    for v in g.values():
        mesh.psum(torch.from_numpy(v), "d")
    assert compressed < mesh.bytes["psum"] / 2, (compressed, mesh.bytes)


def test_loss_shares_add_up_to_the_batch_loss():
    """A masked batch of 8 rows in 4 parts, each part's CE over the whole
    batch's token count (``tokens``): the shares' sum is ``loss_fn``'s
    loss, its CE and aux, and their gradients sum to its gradients."""
    _, _, model, params = _setup("qwen2-moe-a2.7b", LAYERS)
    batch = _batch(model.cfg, B, 4, masked=True)
    kw = dict(impl="full", compute_dtype=torch.float32, groups=2)
    want, wm, wgrads = _port_loss_and_grads(model, params, batch, **kw)
    n_tok = float(batch["mask"][:, 1:].sum())
    got, m, grads = _port_loss_and_grads(
        model, params, batch, parts=4, tokens=n_tok, reduce=True, **kw)
    assert m["ce"].shape == m["aux"].shape == (4,)
    for g, w in ((got, want), (m["ce"].sum(), wm["ce"]),
                 (m["aux"].sum(), wm["aux"])):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5, atol=1e-7)
    _tree_close(grads, wgrads, 1e-5, "grads")


def test_sharded_checkpoint_restores_unsharded(tmp_path):
    """A (2, 2) ZeRO-3 cell's state saved through the gathering
    checkpointer holds the whole leaves: a one-rank cell restores it, and
    the sharded cell restores it laid out again."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_train_cell
    from repro_torch.launch.train import GatheringCheckpointer

    _, _, model, params = _setup("gemma3-1b", LAYERS)
    shape = ShapeConfig("t", S, B, "train")
    cfg = TrainConfig(zero3=True, **KW)
    sharded = make_train_cell(model.cfg, shape,
                              make_local_mesh(2, ranks=4, device="cpu"), cfg)
    one = make_train_cell(model.cfg, shape, make_local_mesh(device="cpu"),
                          cfg)
    state = sharded.place(params)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(model.cfg, B, 5, False).items()}
    state = sharded.step_fn(*state, batch, 3)[:2]
    GatheringCheckpointer(Checkpointer(str(tmp_path)), sharded).save(1, state)
    whole = sharded.gather(*state)
    step, got = Checkpointer(str(tmp_path)).restore_latest(one.place(params))
    assert step == 1
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(whole)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    step, again = GatheringCheckpointer(Checkpointer(str(tmp_path)),
                                        sharded).restore_latest(state)
    for g, w in zip(jax.tree_util.tree_leaves(again),
                    jax.tree_util.tree_leaves(state)):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=0)
