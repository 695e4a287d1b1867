"""The encoder-decoder family of the PyTorch port (whisper-small's
``EncDecLM``) on the CPU, held against the JAX package at
``smoke_config("whisper-small")`` size (2 encoder layers over 32 frames,
4 decoder layers, d_model 128), float32, the same weights drawn with
numpy into the reference's tree and carried across by
``repro_torch.convert``: the init tree's keys and shapes, ``encode`` and
``_cross_kv``, the prefill's logits and whole cache tree, and three
decode steps, at rtol = atol = 1e-4; and the port's prefill and one
decode step against its own full decoder, within 2e-4 as the
reference's ``test_decode_matches_forward``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke_config
from repro.models import build_model as jbuild_model

from tests._torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "whisper-small"
B, PROMPT, CACHE_LEN = 2, 11, 24


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


@functools.lru_cache(maxsize=1)
def _setup():
    """(jax model, jax params, port model, port params, frames): the
    weights drawn with numpy into the reference's tree (norms zero)."""
    from repro_torch import convert
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model

    jmodel = jbuild_model(jsmoke_config(ARCH))
    shapes = jax.eval_shape(lambda k: jmodel.init(k)[0],
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(50)
    np_params = jax.tree_util.tree_map_with_path(
        lambda path, s: np.zeros(s.shape, np.float32)
        if "norm" in jax.tree_util.keystr(path)
        else (rng.normal(size=s.shape) * 0.05).astype(np.float32), shapes)
    model = build_model(smoke_config(ARCH))
    cfg = model.cfg
    frames = rng.normal(size=(B, cfg.encoder.n_frames, cfg.d_model)).astype(
        np.float32)
    return (jmodel, jax.tree_util.tree_map(jnp.asarray, np_params), model,
            convert.params_from_numpy(np_params, "cpu"), frames)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(1, 512, size=shape).astype(
        np.int32)


def test_init_tree_matches_reference():
    """``EncDecLM.init``'s tree (embed, head, both final norms, the
    stacked encoder and decoder blocks with their cross sub-tree) has the
    reference's keys and shapes; its axes tree is the reference's."""
    from repro_torch import convert
    from repro_torch.models.model import EncDecLM

    jmodel, jparams, model, _, _ = _setup()
    assert isinstance(model, EncDecLM)
    own, axes = model.init(torch.Generator().manual_seed(0))
    want = jax.tree_util.tree_map(np.shape, jax.tree_util.tree_map(
        np.asarray, jparams))
    assert jax.tree_util.tree_map(np.shape,
                                  convert.tree_to_numpy(own)) == want
    _, jaxes = jmodel.init(jax.random.PRNGKey(0))
    is_axes = lambda x: isinstance(x, tuple)
    assert jax.tree_util.tree_structure(axes, is_leaf=is_axes) == \
        jax.tree_util.tree_structure(jaxes, is_leaf=is_axes)
    assert jax.tree_util.tree_leaves(axes, is_leaf=is_axes) == \
        jax.tree_util.tree_leaves(jaxes, is_leaf=is_axes)


def test_encode_and_cross_kv_match_reference():
    """The encoder's bidirectional blocks (rope at the frame positions)
    and the per-decoder-layer cross K/V, (L, B, F, KV, hd)."""
    jmodel, jparams, model, params, frames = _setup()
    want_h = jmodel.encode(jparams, jnp.asarray(frames),
                           compute_dtype=jnp.float32)
    got_h = model.encode(params, torch.from_numpy(frames),
                         compute_dtype=torch.float32)
    _close(got_h, want_h, "encode")
    wk, wv = jmodel._cross_kv(jparams, want_h)
    k, v = model._cross_kv(params, got_h)
    _close(k, wk, "cross_k")
    _close(v, wv, "cross_v")


@pytest.mark.parametrize("impl", ["kernel", "auto"])
def test_prefill_and_three_decode_steps_match_reference(impl):
    """Prefill (impl="kernel": K2's plain version on the CPU for every
    attention: the encoder's, the decoder's causal self-attention and its
    cross-attention; "auto": the materialised path) — last-token logits
    and the whole cache tree (self k/v/pos, cross_k, cross_v) — then three
    decode steps, against the reference's (impl "auto")."""
    jmodel, jparams, model, params, frames = _setup()
    prompt = _tokens(3, (B, PROMPT))
    jcache = jmodel.init_cache(B, CACHE_LEN, dtype=jnp.float32)
    want_logits, jcache = jax.jit(lambda p, f, t, c: jmodel.prefill(
        p, {"frames": f, "tokens": t}, c, compute_dtype=jnp.float32))(
        jparams, jnp.asarray(frames), jnp.asarray(prompt), jcache)
    cache = model.init_cache(B, CACHE_LEN, dtype=torch.float32, device="cpu")
    logits, cache = model.prefill(
        params, {"frames": torch.from_numpy(frames),
                 "tokens": torch.from_numpy(prompt)}, cache, impl=impl,
        compute_dtype=torch.float32)
    _close(logits, want_logits, "prefill logits")
    _close(cache, jax.tree_util.tree_map(np.asarray, jcache), "prefill cache")
    jstep = jax.jit(lambda p, c, t, q: jmodel.decode_step(
        p, c, t, q, compute_dtype=jnp.float32))
    for step in range(3):
        tok = _tokens(10 + step, (B,))
        pos = np.full(B, PROMPT + step, np.int32)
        want_logits, jcache = jstep(jparams, jcache, tok, pos)
        logits, cache = model.decode_step(
            params, cache, torch.from_numpy(tok), torch.from_numpy(pos),
            impl=impl, compute_dtype=torch.float32)
        _close(logits, want_logits, f"step {step} logits")
        _close(cache, jax.tree_util.tree_map(np.asarray, jcache),
               f"step {step} cache")


def test_prefill_and_decode_equal_the_full_decoder():
    """Prefill of s tokens and one decode step give the full decoder's
    logits at position s (the reference's ``test_decode_matches_forward``
    for the encoder-decoder family, at its tolerance, 2e-4)."""
    _, _, model, params, frames = _setup()
    s = 17
    tokens = torch.from_numpy(_tokens(4, (B, s + 1)))
    f = torch.from_numpy(frames)
    enc_kv = model._cross_kv(params, model.encode(
        params, f, compute_dtype=torch.float32))
    x, positions = model._tokens_in(params, tokens, torch.float32)
    x, _ = model._decoder(params, x, positions, None, None, enc_kv, "auto")
    full = x[:, s] @ params["head"]
    cache = model.init_cache(B, 32, dtype=torch.float32, device="cpu")
    _, cache = model.prefill(params, {"frames": f, "tokens": tokens[:, :s]},
                             cache, compute_dtype=torch.float32)
    logits, _ = model.decode_step(params, cache, tokens[:, s],
                                  torch.full((B,), s, dtype=torch.int32),
                                  compute_dtype=torch.float32)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=2e-4,
                               atol=2e-4)
