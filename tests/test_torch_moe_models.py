"""The MoE and hybrid models of the PyTorch port on the CPU, held
against the JAX package: the prefill and three decode steps of
qwen2-moe-a2.7b, jamba-1.5-large-398b and arctic-480b at
``smoke_config`` size against the reference's ``DecoderLM`` (float32;
the same weights, drawn with numpy into the reference's tree; rtol =
atol = 1e-4), and the port's prefill against its own decode steps.

A prefill equals its decode steps only when no expert drops a token in
either (capacity depends on the tokens of a call), so that check runs at
capacity factor 8, as the reference's
``test_moe_decode_matches_forward_at_high_capacity`` does (and at its
tolerance, 2e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_moe import (ARCHS, CACHE_LEN, PROMPT, _close, _setup,
                                  _tokens)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_three_decode_steps_match_reference(arch):
    """The prefill (impl="kernel": K2's plain version on the CPU, against
    the reference's full attention) and three decode steps equal the
    reference's, logits and every cache (KV, SSM state and conv
    history); the port's own tree has the reference's keys and shapes."""
    from repro_torch import convert

    jmodel, jparams, model, params = _setup(arch)
    own, _ = model.init(torch.Generator().manual_seed(0))
    assert jax.tree_util.tree_map(np.shape, convert.tree_to_numpy(own)) \
        == jax.tree_util.tree_map(np.shape, jax.tree_util.tree_map(
            np.asarray, jparams))
    prompt = _tokens(3, (2, PROMPT))
    jcache = jmodel.init_cache(2, CACHE_LEN, dtype=jnp.float32)
    want_logits, jcache = jax.jit(lambda p, t, c: jmodel.prefill(
        p, {"tokens": t}, c, impl="full", compute_dtype=jnp.float32))(
        jparams, jnp.asarray(prompt), jcache)
    cache = model.init_cache(2, CACHE_LEN, dtype=torch.float32, device="cpu")
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(prompt)},
                                  cache, impl="kernel",
                                  compute_dtype=torch.float32)
    _close(logits, want_logits, f"{arch} prefill logits")
    _close(cache, jax.tree_util.tree_map(np.asarray, jcache),
           f"{arch} prefill cache")
    jstep = jax.jit(lambda p, c, t, q: jmodel.decode_step(
        p, c, t, q, compute_dtype=jnp.float32))
    for step in range(3):
        tok = _tokens(10 + step, (2,))
        pos = np.full(2, PROMPT + step, np.int32)
        want_logits, jcache = jstep(jparams, jcache, tok, pos)
        logits, cache = model.decode_step(
            params, cache, torch.from_numpy(tok), torch.from_numpy(pos),
            compute_dtype=torch.float32)
        _close(logits, want_logits, f"{arch} step {step} logits")
        _close(cache, jax.tree_util.tree_map(np.asarray, jcache),
               f"{arch} step {step} cache")


def test_prefill_equals_decode_at_high_capacity():
    """With capacity factor 8 no expert drops a token, so a prefill of
    s tokens then one decode step gives the forward's logits at s; jamba
    also with an attention period of 4, so that an SSM layer has an MoE
    FFN."""
    for arch, period in (("qwen2-moe-a2.7b", None),
                         ("jamba-1.5-large-398b", None),
                         ("jamba-1.5-large-398b", 4)):
        _, _, model, params = _setup(arch, 8.0, period)
        assert period is None or "ssm::moe" in model.slot_kinds
        s = 21
        tokens = torch.from_numpy(_tokens(4, (2, s + 1)))
        x, aux = model.forward(params, {"tokens": tokens},
                               compute_dtype=torch.float32)
        assert float(aux) > 0
        full = x[:, s] @ model._head_matrix(params)
        cache = model.init_cache(2, 48, dtype=torch.float32, device="cpu")
        _, cache = model.prefill(params, {"tokens": tokens[:, :s]}, cache,
                                 compute_dtype=torch.float32)
        logits, _ = model.decode_step(params, cache, tokens[:, s],
                                      torch.full((2,), s, dtype=torch.int32),
                                      compute_dtype=torch.float32)
        np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=f"{arch} {period}")


