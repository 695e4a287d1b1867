"""K2's wrapper and plain version against the reference's Pallas kernel
in interpret mode (``tests/test_torch_flash_attention.py``'s cases,
inputs and error measure), in a file of their own so that the suite's
``loadfile`` scheduler runs them beside ``tests/test_differential.py``
rather than ahead of it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from tests.test_torch_flash_attention import PALLAS_CASES, _err, _inputs


@pytest.mark.parametrize("idx", range(len(PALLAS_CASES)))
def test_ops_matches_jax_pallas_interpret(idx):
    from repro_torch.kernels import ops

    case = PALLAS_CASES[idx]
    causal, window, tol = case[6], case[7], case[9]
    q, k, v = _inputs(case, 100 + idx)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v),
                                kind="causal" if causal else "bidir",
                                window=window, block_q=32, block_k=32)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              kind="causal" if causal else "bidir",
                              window=window)
    assert _err(got, want) < tol


@pytest.mark.parametrize("hd", [288, 512])
def test_plain_matches_jax_pallas_kernel_past_256(hd):
    """At a head_dim over 256 (which the wide CUDA kernel takes on the
    card) the plain version equals the reference's
    ``flash_attention_kernel`` in interpret mode: small B/H/S, GQA,
    causal with and without a window, float32 at 2e-5."""
    from repro.kernels import flash_attention as jfa
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(hd)
    b, h, kv, sq, sk = 1, 4, 2, 40, 56
    q = rng.normal(size=(b, h, sq, hd)).astype(np.float32)
    k = rng.normal(size=(b, kv, sk, hd)).astype(np.float32)
    v = rng.normal(size=(b, kv, sk, hd)).astype(np.float32)
    for window in (None, 24):
        want = jfa.flash_attention_kernel(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            window=window, block_q=16, block_k=16, interpret=True)
        got = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 causal=True, window=window)
        assert got.shape == (b, h, sq, hd)
        assert _err(got, want) < 2e-5, (hd, window)
