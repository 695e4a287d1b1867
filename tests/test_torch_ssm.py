"""The SSM family of the PyTorch port on the CPU, held against the JAX
package: mamba2-130m's smoke config (4 layers, width 128, 8 SSM heads of
32, d_state 16, conv 4, chunk 16, tied embeddings), float32.

Both packages get the same parameters: the JAX model's tree (traced with
``jax.eval_shape``) filled from seeded numpy and carried into the port by
``convert.params_from_numpy``.  The matrices are drawn at scales that
make each layer's SSM move the residual stream (the init's 0.02 leaves a
random model repeating its last token, which tells nothing), with the
init's A in (-16, -1) and dt ~ 0.1.  Held at rtol = atol = 1e-4:

* ``ssd_chunked`` with h0 ``None`` and given, at S = 37 (ragged);
* ``_causal_conv`` with a state;
* ``ssm_apply`` prefill and decode;
* ``DecoderLM.prefill`` logits and every layer's ``h`` / ``conv``, and
  three ``decode_step``s after it;
* ``ServeEngine``'s tokens against the reference engine's on 4 requests
  whose prompts span two chunks;
* ``launch.serve --arch mamba2-130m --smoke --device cpu``.

The reference calls are jitted (one XLA compile instead of one per op).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke_config
from repro.models import build_model as jbuild_model
from repro.models import ssm as jssm

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "mamba2-130m"
PROMPT = 24          # > the smoke chunk (16): prefill spans two chunks


def _leaf(name, shape, rng):
    """A parameter of the smoke model, drawn from ``rng``."""
    if name in ("norm", "final_norm"):
        return np.zeros(shape, np.float32)
    if name == "A_log":             # the init's: A = -linspace(1, 16)
        return np.broadcast_to(np.log(np.linspace(1.0, 16.0, shape[-1])),
                               shape).astype(np.float32)
    if name == "D":
        return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
    if name == "dt_bias":           # softplus(-2) ~ 0.13
        return (-2.0 + 0.5 * rng.normal(size=shape)).astype(np.float32)
    scale = {"embed": 0.02}.get(name, 0.5 if name.startswith("conv")
                                else 0.1)
    return (scale * rng.normal(size=shape)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _setup():
    """(jax model, jax params, port model, port params, jax axes)."""
    from repro_torch import convert
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model

    jmodel = jbuild_model(jsmoke_config(ARCH))
    axes = {}

    def init(key):                 # the axes are static: keep the trace's
        params, axes["tree"] = jmodel.init(key)
        return params

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    np_params = jax.tree_util.tree_map_with_path(
        lambda path, s: _leaf(path[-1].key, s.shape, rng), shapes)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    model = build_model(smoke_config(ARCH))
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
    assert got.dtype == want.dtype, (label, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, **TOL, err_msg=label)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _flat(tree, leaf, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, leaf, path + (k,)))
        return out
    return {path: leaf(tree)}


def test_build_and_init_tree_match_reference():
    """mamba2-130m builds at full width; the port's own init builds the
    reference's tree (keys, shapes, logical axes) on the generator's
    device."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.model import DecoderLM

    assert isinstance(build_model(get_config(ARCH)), DecoderLM)
    params, axes = build_model(smoke_config(ARCH)).init(
        torch.Generator().manual_seed(0))
    assert _flat(params, lambda t: tuple(t.shape)) == _flat(
        _setup()[1], lambda t: tuple(t.shape))
    assert _flat(axes, lambda a: a) == _flat(_setup()[4], lambda a: a)
    assert {t.device.type for t in _flat(params, lambda t: t).values()} \
        == {"cpu"}


def _scan_inputs(seed, b=2, s=37, h=3, p=8, n=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            (np.abs(rng.normal(size=(b, s, h))) * 0.2).astype(np.float32),
            (-np.abs(rng.normal(size=(h,))) - 0.1).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32),
            rng.normal(size=(h,)).astype(np.float32),
            rng.normal(size=(b, h, p, n)).astype(np.float32))


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(with_h0):
    from repro_torch.models import ssm

    *args, h0 = _scan_inputs(1)
    h0 = h0 if with_h0 else None
    want = jax.jit(functools.partial(jssm.ssd_chunked, chunk=16))(
        *args, h0=h0)
    got = ssm.ssd_chunked(*(_t(a) for a in args), chunk=16,
                          h0=None if h0 is None else _t(h0))
    _close(got[0], want[0], "y")
    _close(got[1], want[1], "h_final")


def test_causal_conv_with_state_matches_reference():
    from repro_torch.models import ssm

    rng = np.random.default_rng(2)
    u = rng.normal(size=(2, 9, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    state = rng.normal(size=(2, 3, 6)).astype(np.float32)
    for st in (None, state):
        want = jax.jit(jssm._causal_conv)(u, w, st)
        got = ssm._causal_conv(_t(u), _t(w), None if st is None else _t(st))
        _close(got[0], want[0], f"y state={st is not None}")
        _close(got[1], want[1], f"new state state={st is not None}")


def test_ssm_apply_prefill_and_decode_match_reference():
    """Layer 0's SSD block: a prefill from no cache, then one decode step
    from the prefill's cache (the recurrence branch)."""
    from repro_torch import convert
    from repro_torch.models import ssm

    jmodel, jparams, model, params = _setup()[:4]
    cfg = jmodel.cfg.ssm

    def layer0(tree):
        return {k: v[0] for k, v in tree["slots"]["slot0"]["ssm"].items()
                if k != "norm"}

    jp, p = layer0(jparams), layer0(params)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 21, 128)).astype(np.float32)
    step = jax.jit(functools.partial(jssm.ssm_apply, ssm_cfg=cfg))
    want_y, want_cache = step(jp, x)
    y, cache = ssm.ssm_apply(p, _t(x), cfg)
    _close(y, want_y, "prefill y")
    _close(cache, want_cache, "prefill cache")
    x1 = rng.normal(size=(2, 1, 128)).astype(np.float32)
    prefilled = jax.tree_util.tree_map(np.asarray, want_cache)
    want_y, want_cache = step(jp, x1, cache=want_cache)
    y, cache = ssm.ssm_apply(p, _t(x1), cfg,
                             cache=convert.cache_from_numpy(
                                 prefilled, device="cpu"))
    _close(y, want_y, "decode y")
    _close(cache, want_cache, "decode cache")


def _prompts():
    rng = np.random.default_rng(3)
    return rng.integers(1, 512, size=(2, PROMPT)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_prefill():
    jmodel, jparams = _setup()[:2]
    fn = jax.jit(lambda p, t, c: jmodel.prefill(
        p, {"tokens": t}, c, compute_dtype=jnp.float32))
    cache = jmodel.init_cache(2, PROMPT, dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray,
                                  fn(jparams, jnp.asarray(_prompts()), cache))


def test_prefill_and_three_decode_steps_match_reference():
    """Logits and every layer's h / conv after a prefill and after each
    of three decode steps; the caller's cache is left as it was."""
    from repro_torch import convert

    jmodel, jparams, model, params = _setup()[:4]
    want_logits, jcache = _jax_prefill()
    cache = model.init_cache(2, PROMPT, dtype=torch.float32, device="cpu")
    logits, new_cache = model.prefill(params, {"tokens": _t(_prompts())},
                                      cache, compute_dtype=torch.float32)
    _close(logits, want_logits, "prefill logits")
    _close(new_cache, jcache, "prefill cache")
    assert not any(bool(t.any()) for t in cache["slot0"].values())

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


def test_serve_engine_matches_reference_engine():
    from repro.serving import Request as JRequest
    from repro.serving import ServeEngine as JServeEngine
    from repro_torch.serving import Request, ServeEngine

    jmodel, jparams, model, params = _setup()[:4]
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 512, size=PROMPT).tolist() for _ in range(4)]
    # the reference engine prefills eagerly; the same function jitted
    # compiles once (one prompt length) instead of once per op
    jmodel = jbuild_model(jmodel.cfg)
    jmodel.prefill = jax.jit(jmodel.prefill,
                             static_argnames=("compute_dtype",))
    outs = []
    for eng, req in ((JServeEngine(jmodel, jparams, n_slots=2,
                                   cache_len=PROMPT + 8,
                                   compute_dtype=jnp.float32), JRequest),
                     (ServeEngine(model, params, n_slots=2,
                                  cache_len=PROMPT + 8,
                                  compute_dtype=torch.float32), Request)):
        reqs = [req(rid=i, prompt=p, max_new_tokens=4)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        done = eng.run_until_drained()
        assert sorted(r.rid for r in done) == [0, 1, 2, 3]
        outs.append([r.output for r in reqs])
    assert outs[1] == outs[0]


def test_launch_serve_runs_mamba2_on_the_cpu():
    from repro_torch.launch import serve

    reqs = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--requests", "3", "--max-new", "3"])
    assert [len(r.output) for r in reqs] == [3, 3, 3]
    assert all(r.done for r in reqs)
    assert all(0 <= t < 512 for r in reqs for t in r.output)
