"""gemma3-1b's smoke config in the PyTorch port against the JAX package:
the attention paths, prefill under each ``impl`` and the serving engine
(the heaviest cases of ``tests/test_torch_models.py``, whose setup and
helpers they share), in a file of their own so that the suite's
``loadfile`` scheduler runs them beside ``tests/test_differential.py``
rather than ahead of it.  Held at rtol = atol = 1e-4; the engines'
tokens exactly."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jbuild_model
from repro.models import layers as jl
from tests.test_torch_models import (ATTN_CASES, CACHE_LEN, _close,
                                     _jax_prefill, _prompts, _setup, _t)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_paths_match_reference(case):
    from repro_torch.models import layers

    b, sq, sk, h, kv, kind, window = case
    rng = np.random.default_rng(sq * sk + h)
    q = rng.normal(size=(b, sq, h, 16)).astype(np.float32)
    k = rng.normal(size=(b, sk, kv, 16)).astype(np.float32)
    v = rng.normal(size=(b, sk, kv, 16)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(sk - sq, sk, dtype=np.int32), (b, sq))
    kpos = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk))
    args = (_t(q), _t(k), _t(v))
    kw = dict(kind=kind, window=window)
    pos = dict(q_positions=_t(qpos.copy()), k_positions=_t(kpos.copy()))
    want = jax.jit(functools.partial(jl.attention_full, **kw))(
        q, k, v, q_positions=qpos, k_positions=kpos)
    _close(layers.attention_full(*args, **kw, **pos), want, "full")
    want_c = jax.jit(functools.partial(jl.attention_chunked, **kw,
                                       block_kv=8, block_q=16))(
        q, k, v, q_positions=qpos, k_positions=kpos)
    _close(layers.attention_chunked(*args, **kw, **pos, block_kv=8,
                                    block_q=16), want_c, "chunked")
    if kind == "causal":
        # one decode query at the last position, unfilled slots masked
        kpos_d = kpos.copy()
        kpos_d[:, -3:] = np.iinfo(np.int32).max
        want_d = jax.jit(functools.partial(jl.attention_decode,
                                           window=window))(
            q[:, -1:], k, v, q_positions=qpos[:, -1:], k_positions=kpos_d)
        _close(layers.attention_decode(
            _t(q[:, -1:]), _t(k), _t(v), window=window,
            q_positions=_t(qpos[:, -1:].copy()), k_positions=_t(kpos_d)),
            want_d, "decode")


@pytest.mark.parametrize("impl,jimpl", [("full", "full"),
                                        ("chunked", "chunked"),
                                        ("kernel", "pallas")])
def test_prefill_matches_reference(impl, jimpl):
    model, params = _setup()[2:4]
    want_logits, want_cache = _jax_prefill(jimpl)
    cache = model.init_cache(2, CACHE_LEN, dtype=torch.float32,
                             device="cpu")
    logits, new_cache = model.prefill(params, {"tokens": _t(_prompts())},
                                      cache, impl=impl,
                                      compute_dtype=torch.float32)
    _close(logits, want_logits, f"{impl} logits")
    _close(new_cache, want_cache, f"{impl} cache")
    # forward is prefill without the caches: the same last hidden state
    hidden, _ = model.forward(params, {"tokens": _t(_prompts())}, impl=impl,
                              compute_dtype=torch.float32)
    _close(hidden[:, -1] @ params["embed"].T, want_logits, f"{impl} forward")
    # the caller's cache is left as it was (functional, as in JAX)
    assert torch.all(cache["slot0"]["pos"] == 2 ** 31 - 1)


def test_serve_engine_matches_reference_engine():
    from repro.serving import Request as JRequest
    from repro.serving import ServeEngine as JServeEngine
    from repro_torch.serving import Request, ServeEngine

    jmodel, jparams, model, params = _setup()[:4]
    prompts = [[5, 6, 5, 6, 5] * 4, [11] * 20, [7, 8] * 10, list(range(1, 21))]
    # the reference engine prefills eagerly; the same function jitted
    # compiles once (one prompt length, past the local window) instead of
    # once per op
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
