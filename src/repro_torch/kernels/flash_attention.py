"""K2 — flash attention forward: the CUDA kernel's wrapper and its plain
version.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention_kernel``
(the Pallas kernel ``_flash_kernel``).  The kernel is CUDA C++ for Hopper
(``sm_90a``), in ``src/repro_torch/csrc/flash_attention.cu``; its note
says what it computes, what bounds it on the H100 and how it is laid out.

Build: at first use, :mod:`repro_torch.kernels._build` compiles the
source with ``nvcc`` into ``build/kernels/flash_attention_<hash>.so`` and
``ctypes`` loads it.  :func:`build` may be called ahead, e.g. in a thread
while other work runs.

:func:`flash_attention` is the wrapper: tensors on the CPU take
:func:`flash_attention_plain` (the port of
``src/repro/kernels/ref.py::flash_attention_ref``, materialised scores);
CUDA tensors launch the kernel on the current stream or raise.
:data:`LAUNCHES` counts launches by the ``window`` they were given
(``None``: no window).
"""
from __future__ import annotations

import collections
import ctypes
import math

import torch

from repro_torch.kernels import _build

#: Kernel launches so far, by ``window`` (one per :func:`flash_attention`
#: call on CUDA); ``sum(LAUNCHES.values())`` is the total.
LAUNCHES: collections.Counter = collections.Counter()


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.k2_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.k2_error_string.argtypes = [ctypes.c_int]
    lib.k2_error_string.restype = ctypes.c_char_p


_LIBRARY = _build.CudaLibrary("flash_attention.cu", "K2", _bind)
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


def flash_attention_plain(q, k, v, *, causal=True, window=None):
    """Materialised-scores attention, the kernel's function in plain
    PyTorch.  q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd), GQA via
    H = KV * G.  Query row i (position i + Sk - Sq, suffix-aligned) sees
    key j iff (not causal or j <= i + Sk - Sq) and (window is None or
    j > i + Sk - Sq - window); a row that sees no key gives 0."""
    b, h, sq, hd = q.shape
    _, kv, sk, _ = k.shape
    g = h // kv
    off = sk - sq
    qg = q.reshape(b, kv, g, sq, hd).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) / math.sqrt(hd)
    qi = torch.arange(sq, device=q.device)[:, None] + off
    kj = torch.arange(sk, device=q.device)[None, :]
    allowed = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        allowed &= kj <= qi
    if window is not None:
        allowed &= kj > qi - window
    s = s.masked_fill(~allowed, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)      # fully masked rows
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(b, h, sq, hd).to(q.dtype)


def _check(q, k, v):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention wants q (B,H,Sq,hd) and k, v "
                         f"(B,KV,Sk,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or k.shape[1] == 0 \
            or h % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (H must be a multiple of KV)")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v differ in type: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1:
        raise ValueError(f"q, k, v lie on different devices: {devs}")


def flash_attention(q, k, v, *, causal=True, window=None):
    """q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd) -> (B, H, Sq, hd), in q's
    type.  CPU tensors take :func:`flash_attention_plain`; CUDA tensors
    launch K2 (float32, bfloat16 or float16; contiguous; hd <= 256 and a
    multiple of 8; 16-bit tensors 16-byte aligned) or raise."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA, not {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"K2 takes float32, bfloat16 or float16, not "
                         f"{q.dtype}")
    hd = q.shape[3]
    if hd > 256 or hd % 8:
        raise ValueError(f"K2 takes a head_dim <= 256 that is a multiple "
                         f"of 8, not {hd}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("K2 takes contiguous q, k, v")
    if q.dtype != torch.float32 and any(t.data_ptr() % 16
                                        for t in (q, k, v)):
        raise ValueError("K2 reads 16-bit q, k, v 16 bytes at a time: "
                         "they must start 16-byte aligned")
    b, h, sq, _ = q.shape
    kv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = build()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.k2_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, h, kv, sq, sk, hd, int(causal),
            int(window is not None), int(window or 0),
            1.0 / math.sqrt(hd), stream)
    if err:
        raise RuntimeError(f"K2 launch failed: "
                           f"{lib.k2_error_string(err).decode()}")
    LAUNCHES[window] += 1
    return out
