"""The model stack of the PyTorch port on the CPU, held against the JAX
package: gemma3-1b's smoke config (4 layers, a 2-layer local:global
period, width 128, GQA 4:1 heads of 32, window 16), float32.

The JAX model's parameters, taken through numpy, are the port's
(``convert.params_from_numpy``), so both packages compute the same
function.  Held at rtol = atol = 1e-4:

* the layers — ``rms_norm``, ``apply_rope`` (an odd head_dim too), the
  three attention paths with GQA, window, suffix alignment and bidir,
  ``mlp_apply`` gated and ungated;
* ``prefill`` under ``impl`` full / chunked / kernel against the
  reference's full / chunked / pallas (interpret mode): logits and every
  cache;
* three ``decode_step``s after the prefill;
* ``ServeEngine``'s tokens against the reference engine's on 4 requests.

The reference calls are jitted (one XLA compile instead of one per op).

The attention paths, the prefills and the engine are in
``tests/test_torch_serve_engine.py``, which uses this file's setup.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke_config
from repro.models import build_model as jbuild_model
from repro.models import layers as jl

TOL = dict(rtol=1e-4, atol=1e-4)
PROMPT = 20          # > the smoke window (16): the local ring wraps
CACHE_LEN = 32       # != the engine's slot count


@functools.lru_cache(maxsize=None)
def _setup():
    """(jax model, jax params, port model, port params, jax axes) of the
    smoke gemma3-1b.  The reference's init is traced for its tree only
    (``jax.eval_shape``); the weights are drawn from seeded numpy into that
    tree (normal, scale 0.02; norms 0), and the port's are the same arrays
    (``convert.params_from_numpy``)."""
    from repro_torch import convert
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model

    jmodel = jbuild_model(jsmoke_config("gemma3-1b"))
    axes = {}

    def init(key):                 # the axes are static: keep the trace's
        params, axes["tree"] = jmodel.init(key)
        return params

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    np_params = jax.tree_util.tree_map_with_path(
        lambda path, s: np.zeros(s.shape, np.float32)
        if "norm" in jax.tree_util.keystr(path)
        else (rng.normal(size=s.shape) * 0.02).astype(np.float32), shapes)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    model = build_model(smoke_config("gemma3-1b"))
    return (jmodel, jparams, model,
            convert.params_from_numpy(np_params, device="cpu"),
            axes["tree"])


def _close(got, want, label=""):
    from repro_torch import convert

    if isinstance(want, dict):
        assert set(got) == set(want), (label, sorted(got), sorted(want))
        for k in want:
            _close(got[k], want[k], f"{label}/{k}")
        return
    got = convert.tree_to_numpy(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    np.testing.assert_allclose(got, want, **TOL, err_msg=label)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# Configs and parameter trees
# ---------------------------------------------------------------------------


def test_configs_and_init_trees_match_reference():
    """Every registered config equals the reference's, field for field;
    the port's own init builds the reference's tree (keys, shapes,
    logical axes)."""
    import dataclasses

    from repro import configs as jconfigs
    from repro_torch import configs
    from repro_torch.models import build_model

    assert configs.list_archs() == jconfigs.list_archs()
    for arch in configs.list_archs():
        for get in ("get_config", "smoke_config"):
            mine = dataclasses.asdict(getattr(configs, get)(arch))
            assert mine == dataclasses.asdict(getattr(jconfigs, get)(arch))
    cfg = configs.smoke_config("gemma3-1b")
    params, axes = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert _flat(params, lambda t: tuple(t.shape)) == _flat(
        _setup()[1], lambda t: tuple(t.shape))
    assert _flat(axes, lambda a: a) == _flat(_setup()[4], lambda a: a)


def _flat(tree, leaf, path=()):
    """{path: leaf(value)} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, leaf, path + (k,)))
        return out
    return {path: leaf(tree)}


def test_families_without_their_module_name_it():
    """Every family of ``configs/`` now has its module: each registered
    config builds, whisper-small (family ``encdec``) as an ``EncDecLM``
    and every other as a ``DecoderLM``; none raises the port's
    ``NotImplementedError`` (``tests/test_torch_encdec.py`` and
    ``tests/test_torch_moe.py`` hold the models against the
    reference)."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.models import build_model
    from repro_torch.models.model import DecoderLM, EncDecLM

    families = set()
    for arch in list_archs():
        cfg = get_config(arch)
        model = build_model(cfg)
        families.add(cfg.family)
        assert isinstance(model, EncDecLM if cfg.family == "encdec"
                          else DecoderLM), arch
    assert isinstance(build_model(get_config("whisper-small")), EncDecLM)
    assert {"dense", "ssm", "moe", "hybrid", "encdec"} <= families


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def test_norm_rope_and_mlp_match_reference():
    from repro_torch.models import layers

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 3, 33)).astype(np.float32)
    w = rng.normal(size=(33,)).astype(np.float32)
    pos = rng.integers(0, 500, size=(2, 7)).astype(np.int32)
    _close(layers.rms_norm(_t(x), _t(w), 1e-6),
           jax.jit(jl.rms_norm)(x, w), "rms_norm")
    for hd in (33, 32):                  # odd head_dim: its tail passes
        xs = x[..., :hd]
        _close(layers.apply_rope(_t(xs), _t(pos), 10_000.0),
               jax.jit(jl.apply_rope, static_argnums=2)(xs, pos, 10_000.0),
               f"apply_rope hd={hd}")
    h = rng.normal(size=(2, 5, 16)).astype(np.float32)
    p = {k: rng.normal(size=s).astype(np.float32) * 0.2 for k, s in
         (("w_gate", (16, 24)), ("w_up", (16, 24)), ("w_down", (24, 16)))}
    for gated in (True, False):
        pp = p if gated else {k: v for k, v in p.items() if k != "w_gate"}
        _close(layers.mlp_apply({k: _t(v) for k, v in pp.items()}, _t(h),
                                gated=gated),
               jax.jit(functools.partial(jl.mlp_apply, gated=gated))(pp, h),
               f"mlp gated={gated}")


ATTN_CASES = [
    # (b, sq, sk, h, kv, kind, window)
    (2, 24, 24, 4, 1, "causal", None),        # GQA 4:1
    (1, 24, 24, 4, 2, "causal", 8),           # GQA + window
    (1, 10, 26, 4, 1, "causal", 6),           # suffix + window
    (2, 12, 12, 2, 2, "bidir", None),         # bidirectional
]


# ---------------------------------------------------------------------------
# The model: prefill, decode, serving
# ---------------------------------------------------------------------------


def _prompts():
    rng = np.random.default_rng(3)
    return rng.integers(1, 512, size=(2, PROMPT)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_prefill(impl):
    jmodel, jparams = _setup()[:2]
    fn = jax.jit(lambda p, t, c: jmodel.prefill(
        p, {"tokens": t}, c, impl=impl, compute_dtype=jnp.float32))
    cache = jmodel.init_cache(2, CACHE_LEN, dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray,
                                  fn(jparams, jnp.asarray(_prompts()), cache))


def test_three_decode_steps_match_reference():
    from repro_torch import convert

    jmodel, jparams, model, params = _setup()[:4]
    _, jcache = _jax_prefill("full")
    cache = convert.cache_from_numpy(jcache, device="cpu")
    jstep = jax.jit(lambda p, c, t, q: jmodel.decode_step(
        p, c, t, q, compute_dtype=jnp.float32))
    rng = np.random.default_rng(5)
    for step in range(3):
        tok = rng.integers(1, 512, size=2).astype(np.int32)
        pos = np.full(2, PROMPT + step, np.int32)
        want_logits, jcache = jstep(jparams, jcache, tok, pos)
        logits, cache = model.decode_step(params, cache, _t(tok), _t(pos),
                                          compute_dtype=torch.float32)
        _close(logits, want_logits, f"step {step} logits")
        _close(cache, jax.tree_util.tree_map(np.asarray, jcache),
               f"step {step} cache")


def test_serve_driver_runs_on_the_cpu():
    """Greedy, and sampling at a temperature from the seeded generator
    (the same seed draws the same tokens)."""
    from repro_torch.launch import serve

    args = ["--arch", "gemma3-1b", "--smoke", "--device", "cpu",
            "--requests", "3", "--max-new", "3"]
    reqs = serve.main(args)
    assert [len(r.output) for r in reqs] == [3, 3, 3]
    assert all(r.done for r in reqs)
    hot = [serve.main(args + ["--temperature", "2.0"]) for _ in range(2)]
    assert [r.output for r in hot[0]] == [r.output for r in hot[1]]
    assert all(0 <= t < 512 for r in hot[0] for t in r.output)


def test_conversion_helpers_put_trees_on_the_card_unless_asked(monkeypatch):
    """``params_from_numpy`` / ``cache_from_numpy`` follow the port's rule,
    as ``init_cache`` does: the CUDA card by default, the CPU when the
    caller asks; with no card the default raises instead of running on
    the CPU."""
    from repro_torch import convert

    tree = {"blk": {"w": np.ones((2, 3))}, "pos": np.zeros(2, np.int64)}
    for fn in (convert.params_from_numpy, convert.cache_from_numpy):
        got = fn(tree, device="cpu")
        assert got["blk"]["w"].device.type == "cpu"
        assert got["blk"]["w"].dtype == torch.float32
        assert got["pos"].dtype == torch.int32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (convert.params_from_numpy, convert.cache_from_numpy):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(tree)
