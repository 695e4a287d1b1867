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
  suffix+window cases;
* the kernels' work order (``work_order``): every (b, h, q tile) item
  once, longest band first, a band as long as the attention mask says,
  and balanced over the H100's 132 SMs at gemma3-1b's shapes; the
  kernels' input checks.
"""
import functools
import heapq

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


# The kernels' work order: (b, h, sq, sk, causal, window) of the 7 cases
# above and of gemma3-1b's global and local layers over 1 and 2 prompts.
SMALL_ORDER_CASES = [(c[0], c[1], c[3], c[4], c[6], c[7]) for c in CASES]
GEMMA_ORDER_CASES = [(b, 4, 4096, 4096, True, w)
                     for b in (1, 2) for w in (None, 512)]
N_SMS = 132          # H100 SXM


@functools.lru_cache(maxsize=None)
def _tile_work(sq, sk, causal, window, block):
    """Each q tile's count of (block x block) tile pairs that hold an
    allowed (query, key) pair, read off the attention mask itself."""
    qi = np.arange(sq)[:, None] + sk - sq
    kj = np.arange(sk)[None, :]
    allowed = np.ones((sq, sk), bool)
    if causal:
        allowed &= kj <= qi
    if window is not None:
        allowed &= kj > qi - window
    n_qt, n_kt = -(-sq // block), -(-sk // block)
    pad = np.zeros((n_qt * block, n_kt * block), bool)
    pad[:sq, :sk] = allowed
    return pad.reshape(n_qt, block, n_kt, block).any(axis=(1, 3)).sum(axis=1)


def _makespan(work, n=N_SMS):
    """Greedy list scheduling: each item in turn to the least-loaded SM."""
    loads = [0] * n
    for w in work:
        heapq.heapreplace(loads, loads[0] + int(w))
    return max(loads)


# the kernels' tiles: float32 32 x 32, 16 bits 64 x 64
BLOCKS = [32, 64]


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("case", SMALL_ORDER_CASES + GEMMA_ORDER_CASES)
def test_work_order_lists_each_item_once_longest_band_first(case, block):
    from repro_torch.kernels import flash_attention as fa

    b, h, sq, sk, causal, window = case
    items = fa.work_order(b, h, sq, sk, block, causal, window)
    n_qt = -(-sq // block)
    tiles = _tile_work(sq, sk, causal, window, block)
    assert items.dtype == np.int32
    assert np.array_equal(np.sort(items), np.arange(b * h * n_qt))
    assert np.all(np.diff(tiles[items % n_qt]) <= 0)
    # the kernels' band is exactly the tiles that hold an allowed pair
    for t in range(n_qt):
        lo, hi = fa.band_tiles(t * block, min(block, sq - t * block), sq,
                               sk, block, causal, window)
        assert hi - lo == tiles[t]


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("case", GEMMA_ORDER_CASES)
def test_work_order_balances_the_causal_band_over_132_sms(case, block):
    """Items taken greedily in the list's order end within 1.15x of the
    mean load on 132 SMs.  At B=1 one block per 64-row tile in launch
    order (the earlier grid: tiles heaviest first within a head, heads
    one after another, block k on SM k mod 132), or items of 128 rows,
    miss that by about 2x.  An item's work is its count of the kernel's
    (block x block) tile pairs."""
    from repro_torch.kernels import flash_attention as fa

    b, h, sq, sk, causal, window = case
    n_qt = -(-sq // block)
    tiles = _tile_work(sq, sk, causal, window, block)
    work = tiles[fa.work_order(b, h, sq, sk, block, causal, window) % n_qt]
    mean = work.sum() / N_SMS
    assert _makespan(work) <= 1.15 * mean
    if (b, window, block) == (1, None, 64):
        launch_order = np.tile(tiles[::-1], b * h)
        loads = np.bincount(np.arange(len(launch_order)) % N_SMS,
                            weights=launch_order)
        assert loads.max() > 1.9 * mean
        rows128 = tiles.reshape(-1, 2).sum(axis=1)
        wide = np.tile(np.sort(rows128)[::-1], b * h)
        assert _makespan(np.sort(wide)[::-1]) > 1.9 * mean


def test_kernel_input_checks():
    """What the CUDA path refuses before it launches (checked here on CPU
    tensors): other types, a head_dim over 256 or not a multiple of 8,
    non-contiguous tensors, and tensors not 16-byte aligned, which TMA
    and cp.async cannot copy."""
    from repro_torch.kernels import flash_attention as fa

    def qkv(hd, dtype=torch.bfloat16):
        return (torch.zeros(1, 4, 8, hd, dtype=dtype),
                torch.zeros(1, 2, 8, hd, dtype=dtype),
                torch.zeros(1, 2, 8, hd, dtype=dtype))

    for hd, dtype in ((72, torch.bfloat16), (256, torch.float16),
                      (8, torch.float32)):
        fa.check_kernel_inputs(*qkv(hd, dtype))
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        fa.check_kernel_inputs(*qkv(64, torch.float64))
    for hd in (36, 264):
        with pytest.raises(ValueError, match="multiple of 8"):
            fa.check_kernel_inputs(*qkv(hd))
    q, k, v = qkv(64)
    with pytest.raises(ValueError, match="contiguous"):
        fa.check_kernel_inputs(q.transpose(2, 3), k, v)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = qkv(64, dtype)
        shifted = torch.zeros(k.numel() + 1, dtype=dtype)[1:].view(k.shape)
        assert shifted.is_contiguous()
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa.check_kernel_inputs(q, shifted, v)


def test_work_list_tiles_match_the_kernels():
    """The wrapper codes items by ``TILE`` query rows; each kernel decodes
    them by its own ``BQ`` (and walks keys by ``BK``) in the CUDA source,
    which also refuses a list whose length fits another tile size."""
    import re

    from repro_torch.kernels import flash_attention as fa

    src = fa.SOURCE.read_text()
    for ns, dtypes in (("wg", (torch.bfloat16, torch.float16)),
                       ("f32k", (torch.float32,))):
        body = src[src.index(f"namespace {ns} {{"):]
        tiles = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                     body).group(1))
                 for name in ("BQ", "BK")}
        for dtype in dtypes:
            assert tiles == {"BQ": fa.TILE[dtype], "BK": fa.TILE[dtype]}
        assert f"items_fit(a, {ns}::BQ)" in src
