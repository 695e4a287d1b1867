"""K3 (the SSD scan) of the PyTorch port on the CPU, held against the JAX
package.

On CPU tensors the wrapper ``repro_torch.kernels.ssd_scan.ssd_scan_kernel``
takes its plain version (the naive per-token recurrence, without the
``D*x`` skip); the CUDA kernel itself runs on the card only
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).  Inputs come from seeded
numpy and go through both packages, on the 5 cases of
``tests/test_kernels.py::test_ssd_scan_vs_oracle``:

* ``ssd_scan_plain`` (with D) against JAX ``ref.ssd_ref``: y and h_final;
* the port's ``ops.ssd_scan`` against JAX ``ops.ssd_scan`` (the Pallas
  kernel in interpret mode) and against ``ref.ssd_ref``.

Tolerance: rtol = atol = 1e-4 in float32, 1e-1 in float16 (one float16
rounding of outputs of order 10 is ~1e-2; the two packages round in
different places).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref

# (b, s, h, p, n, chunk, dtype) of test_kernels.py
CASES = [
    (1, 64, 2, 16, 8, 16, np.float32),
    (2, 100, 4, 32, 16, 32, np.float32),     # ragged chunks
    (1, 128, 3, 64, 128, 64, np.float32),
    (2, 48, 2, 32, 16, 16, np.float16),
    (1, 33, 1, 8, 4, 64, np.float32),        # chunk > seq
]


def _tol(dtype):
    return 1e-4 if dtype == np.float32 else 1e-1


def _inputs(case, seed):
    b, s, h, p, n, _, dtype = case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(dtype)
    dt = np.abs(rng.normal(size=(b, s, h))).astype(np.float32) * 0.1
    A = (-np.abs(rng.normal(size=(h,))) - 0.1).astype(np.float32)
    Bm = rng.normal(size=(b, s, n)).astype(dtype)
    Cm = rng.normal(size=(b, s, n)).astype(dtype)
    D = rng.normal(size=(h,)).astype(np.float32)
    return x, dt, A, Bm, Cm, D


def _close(got, want, tol, label):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=label)


@pytest.mark.parametrize("idx", range(len(CASES)))
def test_plain_and_ops_match_jax(idx):
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd

    case = CASES[idx]
    chunk, tol = case[5], _tol(case[6])
    args = _inputs(case, idx)
    want_y, want_h = jax.jit(jref.ssd_ref)(*args)
    want_ops = jops.ssd_scan(*(jnp.asarray(a) for a in args), chunk=chunk)
    targs = [torch.from_numpy(a) for a in args]

    y, h = ssd.ssd_scan_plain(*targs)
    assert y.dtype == targs[0].dtype and h.dtype == torch.float32
    _close(y, want_y, tol, "plain y vs ssd_ref")
    _close(h, want_h, 1e-4, "plain h_final vs ssd_ref")

    before = ssd.LAUNCHES
    got = ops.ssd_scan(*targs, chunk=chunk)
    assert got.shape == targs[0].shape and got.dtype == targs[0].dtype
    _close(got, want_ops, tol, "ops.ssd_scan vs JAX ops.ssd_scan")
    _close(got, want_y, tol, "ops.ssd_scan vs ssd_ref")
    # the kernel's contract leaves the D*x skip to ops
    x, D = targs[0], targs[5]
    _close(ssd.ssd_scan_kernel(*targs[:5], chunk=chunk) + x * D[:, None].to(
        x.dtype), got, 0.0, "kernel + D*x == ops")
    # CPU tensors launch nothing
    assert ssd.LAUNCHES == before


def test_wrapper_checks_its_inputs():
    """Shapes, types and devices are checked before anything runs, and a
    tensor that is neither on the CPU nor on CUDA is refused."""
    from repro_torch.kernels import ssd_scan as ssd

    x = torch.zeros(1, 8, 2, 4)
    dt = torch.zeros(1, 8, 2)
    A = -torch.ones(2)
    Bm = torch.zeros(1, 8, 3)
    with pytest.raises(ValueError, match="shapes do not fit"):
        ssd.ssd_scan_kernel(x, dt[:, :4], A, Bm, Bm)
    with pytest.raises(ValueError, match="shapes do not fit"):
        ssd.ssd_scan_kernel(x, dt, A, Bm, torch.zeros(1, 8, 4))
    with pytest.raises(ValueError, match=r"x \(B,S,H,P\)"):
        ssd.ssd_scan_kernel(x[0], dt, A, Bm, Bm)
    with pytest.raises(ValueError, match="chunk must be positive"):
        ssd.ssd_scan_kernel(x, dt, A, Bm, Bm, chunk=0)
    meta = [t.to("meta") for t in (x, dt, A, Bm, Bm)]
    with pytest.raises(ValueError, match="runs on CUDA, not meta"):
        ssd.ssd_scan_kernel(*meta)
    with pytest.raises(ValueError, match="different devices"):
        ssd.ssd_scan_kernel(x, dt, A, Bm, Bm.to("meta"))
    # what only the kernel refuses (CPU tensors take the plain version,
    # which takes them all)
    with pytest.raises(ValueError, match="of one type"):
        ssd.check_kernel_inputs(x, dt, A, Bm.half(), Bm)
    with pytest.raises(ValueError, match="of one type"):
        ssd.check_kernel_inputs(x.double(), dt, A, Bm.double(), Bm.double())
    with pytest.raises(ValueError, match="float32 dt and A"):
        ssd.check_kernel_inputs(x, dt.half(), A, Bm, Bm)
    with pytest.raises(ValueError, match="contiguous"):
        ssd.check_kernel_inputs(x.transpose(1, 2).contiguous().transpose(
            1, 2), dt, A, Bm, Bm)
    wide = torch.zeros(1, 8, ssd.MAX_N + 1)
    with pytest.raises(ValueError, match="state width"):
        ssd.check_kernel_inputs(x, dt, A, wide, wide)
    ssd.check_kernel_inputs(x, dt, A, Bm, Bm)
    ssd.check_kernel_inputs(x.bfloat16(), dt, A, Bm.bfloat16(),
                            Bm.bfloat16())
