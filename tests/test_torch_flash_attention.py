"""K2 (flash attention) of the PyTorch port on the CPU, held against the
JAX package.

On CPU tensors the wrapper ``repro_torch.kernels.flash_attention`` takes
its plain version (materialised scores); the CUDA kernel itself runs on
the card only (``tests/test_torch_gpu.py``, ``chip_smoke.py``).  Inputs
come from seeded numpy and go through both packages:

* the plain version and ``ops.flash_attention`` against JAX
  ``ref.flash_attention_ref`` on the 7 cases of
  ``tests/test_kernels.py::test_flash_attention_vs_oracle``, at its
  tolerances (2e-5 in float32, 5e-2 in float16);
* ``ops.flash_attention`` against JAX ``ops.flash_attention`` (the Pallas
  kernel in interpret mode) on the GQA+window, ragged-f16 and
  suffix+window cases.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref

# (b, h, kv, sq, sk, hd, causal, window, dtype, tol) of test_kernels.py
CASES = [
    (1, 4, 4, 64, 64, 32, True, None, np.float32, 2e-5),
    (2, 8, 2, 128, 128, 64, True, None, np.float32, 2e-5),
    (1, 4, 1, 96, 96, 64, True, 32, np.float32, 2e-5),     # GQA+window
    (2, 4, 4, 1, 160, 64, True, None, np.float32, 2e-5),   # decode
    (1, 2, 2, 64, 64, 128, False, None, np.float32, 2e-5), # bidir
    (1, 4, 2, 200, 200, 64, True, None, np.float16, 5e-2), # ragged+fp16
    (1, 2, 1, 48, 80, 32, True, 16, np.float32, 2e-5),     # suffix+win
]
PALLAS_CASES = [CASES[2], CASES[5], CASES[6]]


def _inputs(case, seed):
    b, h, kv, sq, sk, hd, _, _, dtype, _ = case
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, hd)).astype(dtype),
            rng.normal(size=(b, sk, kv, hd)).astype(dtype),
            rng.normal(size=(b, sk, kv, hd)).astype(dtype))


def _err(got, want) -> float:
    return float(np.max(np.abs(got.float().numpy()
                               - np.asarray(want, np.float32))))


@pytest.mark.parametrize("idx", range(len(CASES)))
def test_plain_and_ops_match_jax_oracle(idx):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    case = CASES[idx]
    causal, window, tol = case[6], case[7], case[9]
    q, k, v = _inputs(case, idx)
    want = jax.jit(lambda q, k, v: jref.flash_attention_ref(
        q.swapaxes(1, 2), k.swapaxes(1, 2), v.swapaxes(1, 2),
        causal=causal, window=window))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    before = sum(fa.LAUNCHES.values())
    plain = fa.flash_attention(tq.transpose(1, 2).contiguous(),
                               tk.transpose(1, 2).contiguous(),
                               tv.transpose(1, 2).contiguous(),
                               causal=causal, window=window)
    assert plain.dtype == tq.dtype
    assert _err(plain, want) < tol
    got = ops.flash_attention(tq, tk, tv,
                              kind="causal" if causal else "bidir",
                              window=window)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    assert _err(got, np.asarray(want).swapaxes(1, 2)) < tol
    # CPU tensors launch nothing
    assert sum(fa.LAUNCHES.values()) == before


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


def test_wrapper_checks_its_inputs():
    """Shapes and devices are checked before anything runs, and a tensor
    that is neither on the CPU nor on CUDA is refused, not computed."""
    from repro_torch.kernels import flash_attention as fa

    q = torch.zeros(1, 4, 8, 32)
    kv = torch.zeros(1, 3, 8, 32)
    with pytest.raises(ValueError, match="multiple of KV"):
        fa.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="differ in type"):
        fa.flash_attention(q, q.half(), q)
    meta = torch.zeros(1, 4, 8, 32, device="meta")
    with pytest.raises(ValueError, match="runs on CUDA, not meta"):
        fa.flash_attention(meta, meta, meta)
