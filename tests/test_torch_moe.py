"""The MoE and hybrid families of the PyTorch port on the CPU, held
against the JAX package: ``models/moe.py`` (twins of
``tests/test_moe.py``'s four checks, against the reference's
``moe_apply`` and ``_dispatch_one_group``: outputs, aux loss and dropped
share), one ``ssm::moe`` block (an SSM mixer with an MoE FFN, jamba's) against
the reference's ``block_apply``, and the port's ``ServeEngine`` against
the reference engine on qwen2-moe's smoke config (float32; the same
weights, drawn with numpy into the reference's tree).  The models'
prefill and decode are held in ``tests/test_torch_moe_models.py``.

Tolerances: rtol = atol = 1e-4 (the model tests' rule) for outputs; the
dispatch table and the dropped share are equal exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MoEConfig as JMoEConfig
from repro.configs import smoke_config as jsmoke_config
from repro.models import build_model as jbuild_model
from repro.models import moe as jmoe

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("qwen2-moe-a2.7b", "jamba-1.5-large-398b", "arctic-480b")
PROMPT = 20
CACHE_LEN = 32


def _close(got, want, label=""):
    from repro_torch import convert

    if isinstance(want, dict):
        assert set(got) == set(want), (label, sorted(got), sorted(want))
        for k in want:
            _close(got[k], want[k], f"{label}/{k}")
        return
    got = convert.tree_to_numpy(got) if isinstance(got, (dict, torch.Tensor)) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    np.testing.assert_allclose(got, want, **TOL, err_msg=label)


def _numpy_tree(shapes, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: np.zeros(s.shape, np.float32)
        if "norm" in jax.tree_util.keystr(path)
        else (rng.normal(size=s.shape) * scale).astype(np.float32), shapes)


# ---------------------------------------------------------------------------
# moe_apply, twins of tests/test_moe.py
# ---------------------------------------------------------------------------


def _cfgs(**kw):
    from repro_torch.configs.base import MoEConfig

    base = dict(n_experts=6, top_k=2, d_expert=16, capacity_factor=8.0)
    base.update(kw)
    return MoEConfig(**base), JMoEConfig(**base)


def _moe_params(jcfg, seed, d=32):
    def init(key):
        tree = jmoe.init_moe(key, d, jcfg)
        return jax.tree_util.tree_map(
            lambda t: t[0], tree, is_leaf=lambda t: isinstance(t, tuple)
            and hasattr(t[0], "shape"))
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return _numpy_tree(shapes, seed, scale=0.3)


def _both(np_p, x, cfg, jcfg, groups):
    from repro_torch import convert
    from repro_torch.models import moe

    p = convert.params_from_numpy(np_p, device="cpu")
    got = moe.moe_apply(p, torch.from_numpy(x), cfg, groups=groups)
    want = jax.jit(functools.partial(jmoe.moe_apply, moe_cfg=jcfg,
                                     groups=groups))(np_p, jnp.asarray(x))
    return got, want


def _dense_reference(p, x, cfg):
    """Token-exact MoE (no capacity), as tests/test_moe.py computes it."""
    e = cfg.n_experts
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, p["router"]), -1)
    vals, idx = jax.lax.top_k(probs, cfg.top_k)
    vals = vals / jnp.sum(vals, axis=-1, keepdims=True)
    full_w = sum(vals[..., k:k + 1] * jax.nn.one_hot(idx[..., k], e)
                 for k in range(cfg.top_k))
    h = jnp.einsum("bsd,edf->bsef", x, p["w_gate"][:e])
    u = jnp.einsum("bsd,edf->bsef", x, p["w_up"][:e])
    o = jnp.einsum("bsef,efd->bsed", jax.nn.silu(h) * u, p["w_down"][:e])
    return jnp.einsum("bsed,bse->bsd", o, full_w)


def test_moe_matches_reference_and_dense_at_high_capacity():
    cfg, jcfg = _cfgs()
    np_p = _moe_params(jcfg, 1)
    x = np.random.default_rng(11).normal(size=(2, 24, 32)).astype(np.float32)
    (y, aux), (jy, jaux) = _both(np_p, x, cfg, jcfg, groups=2)
    _close(y, jy, "y")
    _close(aux, jaux, "aux")
    _close(y, _dense_reference(np_p, x, jcfg), "dense")


def test_expert_padding_is_routing_invisible():
    """n_padded=8: the padded experts never route (-1e9 logits), so the
    output equals the unpadded model's with the first 6 experts."""
    from repro_torch import convert
    from repro_torch.models import moe

    cfg6, _ = _cfgs()
    cfg8, jcfg8 = _cfgs(n_padded=8)
    np_p = _moe_params(jcfg8, 2)
    x = np.random.default_rng(12).normal(size=(2, 16, 32)).astype(np.float32)
    (y8, aux8), (jy8, jaux8) = _both(np_p, x, cfg8, jcfg8, groups=1)
    _close(y8, jy8, "padded")
    _close(aux8, jaux8, "padded aux")
    p6 = {k: (v[:6] if k in ("w_gate", "w_up", "w_down") else v)
          for k, v in np_p.items()}
    y6, _ = moe.moe_apply(convert.params_from_numpy(p6, device="cpu"),
                          torch.from_numpy(x), cfg6, groups=1)
    np.testing.assert_allclose(y8.numpy(), y6.numpy(), rtol=1e-5, atol=1e-5)


def test_capacity_drops_bounded_and_equal_to_reference():
    """At capacity factor 0.5 tokens drop: the output stays finite, the
    aux loss is positive, and outputs, aux, the dispatch table, the slot
    weights, the routing and the dropped share equal the reference's."""
    from repro_torch.models import moe

    cfg, jcfg = _cfgs(capacity_factor=0.5)
    np_p = _moe_params(jcfg, 3)
    x = np.random.default_rng(13).normal(size=(1, 64, 32)).astype(np.float32)
    (y, aux), (jy, jaux) = _both(np_p, x, cfg, jcfg, groups=1)
    assert bool(torch.isfinite(y).all()) and float(aux) > 0
    _close(y, jy, "y")
    _close(aux, jaux, "aux")
    logits = x[0] @ np_p["router"]
    cap = max(1, int(2 * 64 * 0.5 / 6))
    got = moe._dispatch_one_group(torch.from_numpy(x[0]),
                                  torch.from_numpy(logits), 2, cap)
    want = jax.jit(jmoe._dispatch_one_group, static_argnums=(2, 3))(
        x[0], logits, 2, cap)
    for name, g, w in zip(("gathered", "table", "valid", "w_slot", "aux",
                           "dropped"), got, want):
        if name in ("table", "valid"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
        else:
            _close(g, w, name)
    assert 0 < float(got[5]) == pytest.approx(float(want[5]), abs=1e-7)


def test_shared_and_dense_residual_paths():
    cfg, jcfg = _cfgs(n_shared=1, shared_d_ff=24, dense_residual_d_ff=24)
    np_p = _moe_params(jcfg, 4)
    assert "shared" in np_p and "dense" in np_p
    x = np.random.default_rng(14).normal(size=(2, 8, 32)).astype(np.float32)
    (y, aux), (jy, jaux) = _both(np_p, x, cfg, jcfg, groups=1)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    _close(y, jy, "y")
    _close(aux, jaux, "aux")


def test_ssm_mixer_with_an_moe_ffn_matches_reference():
    """One ``ssm::moe`` block (jamba's full config has an MoE FFN on every
    other layer, most of them SSM layers; its smoke config puts the MoE
    FFN on its attention layers only) against the reference's
    ``block_apply``: the output and the aux loss."""
    from repro.models import blocks as jblocks
    from repro_torch import convert
    from repro_torch.configs import smoke_config
    from repro_torch.models import blocks

    arch, kind = "jamba-1.5-large-398b", "ssm::moe"
    cfg, jcfg = smoke_config(arch), jsmoke_config(arch)

    def init(key):
        return jax.tree_util.tree_map(
            lambda t: t[0], jblocks.init_block(key, jcfg, kind),
            is_leaf=lambda t: isinstance(t, tuple) and hasattr(t[0], "shape"))
    np_p = _numpy_tree(jax.eval_shape(init, jax.random.PRNGKey(0)), 5,
                       scale=0.05)
    x = np.random.default_rng(15).normal(size=(2, 12, 128)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    jx, _, jaux = jax.jit(lambda p, x: jblocks.block_apply(
        p, x, jcfg, kind, positions=pos))(np_p, x)
    got, _, aux = blocks.block_apply(
        convert.params_from_numpy(np_p, "cpu"), torch.from_numpy(x), cfg,
        kind, positions=torch.from_numpy(pos))
    _close(got, jx, "ssm::moe block")
    _close(aux, jaux, "ssm::moe aux")
    assert float(aux) > 0


# ---------------------------------------------------------------------------
# The serving engine against the reference's
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _setup(arch, capacity_factor=None, attn_layer_period=None):
    """(jax model, jax params, port model, port params) at smoke size; the
    weights drawn with numpy into the reference's tree.  jamba's smoke
    config puts attention and the MoE FFN on the same (odd) layers; an
    attention period of 4 gives its full config's SSM layers with an MoE
    FFN too (layer 1 of 4)."""
    from repro_torch import convert
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model

    jcfg, cfg = jsmoke_config(arch), smoke_config(arch)
    if attn_layer_period is not None:
        jcfg = dataclasses.replace(jcfg, attn_layer_period=attn_layer_period)
        cfg = dataclasses.replace(cfg, attn_layer_period=attn_layer_period)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    jmodel = jbuild_model(jcfg)
    shapes = jax.eval_shape(lambda k: jmodel.init(k)[0],
                            jax.random.PRNGKey(0))
    np_params = _numpy_tree(shapes, ARCHS.index(arch), scale=0.05)
    return (jmodel, jax.tree_util.tree_map(jnp.asarray, np_params),
            build_model(cfg), convert.params_from_numpy(np_params, "cpu"))


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(1, 512, size=shape).astype(
        np.int32)


def test_serve_engine_matches_reference_engine_on_qwen2_moe():
    from repro.serving import Request as JRequest
    from repro.serving import ServeEngine as JServeEngine
    from repro_torch.serving import Request, ServeEngine

    jmodel, jparams, model, params = _setup("qwen2-moe-a2.7b")
    prompts = [[5, 6, 5, 6, 5] * 4, [11] * 20, [7, 8] * 10, list(range(1, 21))]
    jmodel = jbuild_model(jmodel.cfg)
    jmodel.prefill = jax.jit(jmodel.prefill,
                             static_argnames=("compute_dtype",))
    outs = []
    for eng, req in ((JServeEngine(jmodel, jparams, n_slots=2,
                                   cache_len=CACHE_LEN,
                                   compute_dtype=jnp.float32), JRequest),
                     (ServeEngine(model, params, n_slots=2,
                                  cache_len=CACHE_LEN,
                                  compute_dtype=torch.float32), Request)):
        reqs = [req(rid=i, prompt=p, max_new_tokens=4)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        done = eng.run_until_drained()
        assert sorted(r.rid for r in done) == [0, 1, 2, 3]
        outs.append([r.output for r in reqs])
    assert outs[1] == outs[0]
