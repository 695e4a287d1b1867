"""K3 — the Mamba-2 SSD chunked scan: the CUDA kernel's wrapper and its
plain version.

Replaces ``src/repro/kernels/ssd_scan.py::ssd_scan_kernel`` (the Pallas
kernel ``_ssd_kernel``).  The kernel is CUDA C++ for Hopper (``sm_90a``),
in ``src/repro_torch/csrc/ssd_scan.cu``; its note says what it computes,
what bounds it on the H100 and how the work is split (five grids; the
products on the tensor cores with ``mma.sync``, C.B^T formed once per
(b, chunk) into a float32 scratch the heads share).

Build: at first use, :mod:`repro_torch.kernels._build` compiles the
source with ``nvcc`` into ``build/kernels/ssd_scan_<hash>.so`` and
``ctypes`` loads it.  :func:`build` may be called ahead, e.g. in a thread
while other work runs.

:func:`ssd_scan_kernel` is the wrapper: tensors on the CPU take
:func:`ssd_scan_plain` (the port of ``src/repro/kernels/ref.py::ssd_ref``,
the naive per-token recurrence) without the ``D*x`` skip, as the kernel
leaves it out; CUDA tensors launch the kernel on the current stream or
raise.  :data:`LAUNCHES` counts launches (one per call on CUDA).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: Kernel launches so far (one per :func:`ssd_scan_kernel` call on CUDA).
LAUNCHES = 0
MAX_N = 256                     # d_state the kernel takes
#: The longest chunk the output pass holds C.B^T for; the output does not
#: depend on the chunk but for rounding, so a longer one runs as this.
MAX_CHUNK = 256


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.k3_ssd_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.k3_error_string.argtypes = [ctypes.c_int]
    lib.k3_error_string.restype = ctypes.c_char_p


_LIBRARY = _build.CudaLibrary("ssd_scan.cu", "K3", _bind)
SOURCE = _LIBRARY.source
NVCC_FLAGS = _build.NVCC_FLAGS
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: What nvcc printed for the last build (ptxas registers, spills, smem).
BUILD_LOG = ""


def build() -> ctypes.CDLL:
    """Compile the kernel (once per source and flags) and load it."""
    global BUILD_LOG
    lib = _LIBRARY.load()
    BUILD_LOG = _LIBRARY.log
    return lib


def ssd_scan_plain(x, dt, A, Bm, Cm, D=None):
    """The naive per-token SSD recurrence, in float32.

    x: (b, s, h, p); dt: (b, s, h) post-softplus; A: (h,) negative;
    Bm, Cm: (b, s, n); D: (h,) or ``None`` (no ``D*x`` skip, the
    kernel's contract).  Returns (y (b, s, h, p) in x's type, h_final
    (b, h, p, n) float32)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    f32 = torch.float32
    xf, dtf = x.to(f32), dt.to(f32)
    Bf, Cf = Bm.to(f32), Cm.to(f32)
    state = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * A)                         # (b, h)
        upd = torch.einsum("bh,bn,bhp->bhpn", dtf[:, t], Bf[:, t], xf[:, t])
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bn,bhpn->bhp", Cf[:, t], state))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(xf)
    if D is not None:
        y = y + xf * D[:, None]
    return y.to(x.dtype), state


def _check(x, dt, A, Bm, Cm):
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 3:
        raise ValueError(f"ssd_scan wants x (B,S,H,P), dt (B,S,H), A (H,), "
                         f"Bm/Cm (B,S,N); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}")
    b, s, h, _ = x.shape
    if (tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,)
            or Bm.shape[:2] != (b, s) or Cm.shape != Bm.shape):
        raise ValueError(f"ssd_scan: shapes do not fit x {tuple(x.shape)}: "
                         f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    devs = {t.device for t in (x, dt, A, Bm, Cm)}
    if len(devs) != 1:
        raise ValueError(f"ssd_scan inputs lie on different devices: {devs}")


def check_kernel_inputs(x, dt, A, Bm, Cm) -> None:
    """Raise on inputs of fitting shapes that the kernel cannot take."""
    if x.dtype not in _DTYPES or not (x.dtype == Bm.dtype == Cm.dtype):
        raise ValueError(f"K3 takes x, Bm, Cm of one type (float32, "
                         f"bfloat16 or float16), not {x.dtype}, {Bm.dtype}, "
                         f"{Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"K3 takes float32 dt and A, not {dt.dtype}, "
                         f"{A.dtype}")
    if not all(t.is_contiguous() for t in (x, dt, A, Bm, Cm)):
        raise ValueError("K3 takes contiguous x, dt, A, Bm, Cm")
    if Bm.shape[2] > MAX_N:
        raise ValueError(f"K3 takes a state width N <= {MAX_N}, not "
                         f"{Bm.shape[2]}")


def ssd_scan_kernel(x, dt, A, Bm, Cm, *, chunk=128):
    """x: (B, S, H, P); dt: (B, S, H) post-softplus; A: (H,) negative;
    Bm, Cm: (B, S, N) -> y (B, S, H, P) in x's type, without the ``D*x``
    skip.  CPU tensors take :func:`ssd_scan_plain`; CUDA tensors launch
    K3 (x, Bm, Cm of one type: float32, bfloat16 or float16; dt and A
    float32; all contiguous; N <= 256) or raise.  A ``chunk`` over
    :data:`MAX_CHUNK` (256) runs as 256 on the card: the output does not
    depend on the chunk but for float32 rounding, and the plain version
    takes none."""
    global LAUNCHES
    _check(x, dt, A, Bm, Cm)
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk must be positive, not {chunk}")
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm)[0]
    if x.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA, not {x.device}")
    check_kernel_inputs(x, dt, A, Bm, Cm)
    b, s, h, p = x.shape
    n = Bm.shape[2]
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    q = min(chunk, s, MAX_CHUNK)
    nc = -(-s // q)
    f32 = dict(dtype=torch.float32, device=x.device)
    acum = torch.empty((b, h, nc, q), **f32)
    a_last = torch.empty((b, h, nc), **f32)
    state = torch.empty((b, h, nc, n, p), **f32)
    qp = -(-q // 64) * 64
    cb = torch.empty((b, nc, qp, qp), **f32)        # C.B^T, shared by heads
    # every row of x, Bm, Cm and the state 16-byte aligned: tiles come by
    # cp.async, 16 bytes at a time
    size = x.element_size()
    vec = int(all(t.data_ptr() % 16 == 0 for t in (x, Bm, Cm))
              and n * size % 16 == 0 and p * size % 16 == 0 and p % 4 == 0)
    lib = build()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.k3_ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), acum.data_ptr(), a_last.data_ptr(),
            state.data_ptr(), cb.data_ptr(), _DTYPES[x.dtype], b, s, h, p,
            n, q, vec, stream)
    if err:
        raise RuntimeError(f"K3 launch failed: "
                           f"{lib.k3_error_string(err).decode()}")
    LAUNCHES += 1
    return y
