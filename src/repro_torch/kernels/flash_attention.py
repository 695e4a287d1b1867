"""K2 — flash attention forward: the CUDA kernels' wrapper, their work
order and their plain version.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention_kernel``
(the Pallas kernel ``_flash_kernel``).  The kernels are CUDA C++ for
Hopper (``sm_90a``), in ``src/repro_torch/csrc/flash_attention.cu``:
``wgmma`` fed by a TMA ring for bfloat16 and float16, register-tiled FMAs
for float32, and for a head_dim over 256 (any type) a kernel whose
blocks each own a slice of at most 256 output columns and form Q K^T
over the whole head dim in 64-column slices; its note says what they
compute, what bounds them on the H100 and how they are laid out.

Build: at first use, :mod:`repro_torch.kernels._build` compiles the
source with ``nvcc`` into ``build/kernels/flash_attention_<hash>.so`` and
``ctypes`` loads it.  :func:`build` may be called ahead, e.g. in a thread
while other work runs.

:func:`flash_attention` is the wrapper: tensors on the CPU take
:func:`flash_attention_plain` (the port of
``src/repro/kernels/ref.py::flash_attention_ref``, materialised scores);
CUDA tensors launch the kernel on the current stream or raise.
:data:`LAUNCHES` counts launches by the ``window`` they were given
(``None``: no window).  :func:`work_order` is the list of (b, h, q tile)
items, longest band first, that the kernels' persistent blocks take in
turn.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import _build

#: Kernel launches so far, by ``window`` (one per :func:`flash_attention`
#: call on CUDA); ``sum(LAUNCHES.values())`` is the total.
LAUNCHES: collections.Counter = collections.Counter()


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.k2_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    wide = lib.k2_flash_attention_wide_fwd
    wide.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                     + [ctypes.c_float, ctypes.c_void_p])
    wide.restype = ctypes.c_int
    lib.k2_error_string.argtypes = [ctypes.c_int]
    lib.k2_error_string.restype = ctypes.c_char_p


_LIBRARY = _build.CudaLibrary("flash_attention.cu", "K2", _bind)
SOURCE = _LIBRARY.source
NVCC_FLAGS = _build.NVCC_FLAGS
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: Query rows (and keys) of one kernel tile, by type: the float32 kernel's
#: 32 x 32 FMA tiles, the 16-bit kernel's 64 x 64 wgmma tiles.
TILE = {torch.float32: 32, torch.bfloat16: 64, torch.float16: 64}
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


def band_tiles(q0, rows, sq, sk, block_k, causal, window):
    """The key tiles ``[lo, hi)`` of ``block_k`` keys that query rows
    ``[q0, q0 + rows)`` may see (the kernels' ``band``): keys below the
    first row's window and above the last row's causal limit are never
    visited."""
    off = sk - sq
    k_lo, k_hi = 0, sk
    if causal:
        k_hi = min(sk, q0 + rows + off)
    if window is not None:
        k_lo = max(0, q0 + off - window + 1)
    lo = k_lo // block_k
    return lo, (-(-k_hi // block_k) if k_hi > k_lo else lo)


def work_order(b, h, sq, sk, block, causal, window):
    """The kernels' work list: every (batch, head, q tile) item once, as
    the int32 code ``(b_i * h + h_i) * n_q_tiles + q_tile``, longest band
    first across all batches and heads (ties in code order).  Tiles are
    ``block`` query rows and ``block`` keys; a band's length is its count
    of key tiles.  The kernels' persistent blocks take the items in this
    order, each the next one when it is free."""
    n_qt = -(-sq // block)
    tiles = np.array([np.subtract(*band_tiles(
        t * block, min(block, sq - t * block), sq, sk, block, causal,
        window)[::-1]) for t in range(n_qt)], dtype=np.int64)
    work = np.tile(tiles, b * h)
    codes = np.arange(b * h * n_qt, dtype=np.int64)
    return codes[np.lexsort((codes, -work))].astype(np.int32)


@functools.lru_cache(maxsize=64)
def _work_list(device, b, h, sq, sk, block, causal, window):
    """:func:`work_order` as an int32 tensor on ``device`` (made once per
    shape: a prefill calls each shape once per layer)."""
    return torch.from_numpy(work_order(b, h, sq, sk, block, causal,
                                       window)).to(device)


#: The kernels' int32 work counters, one per (device, stream): 0 before a
#: launch, counted up by its blocks, set back to 0 by its last block.
_COUNTERS: dict = {}


def _counter(device, stream):
    """The work counter of launches on ``stream`` (launches on one stream
    never overlap, so they can share it); made, zeroed, on first use."""
    key = (device, stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _COUNTERS[key]


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


def check_kernel_inputs(q, k, v):
    """What the CUDA kernels take beyond :func:`_check`'s shapes: float32,
    bfloat16 or float16; a head_dim that is a multiple of 8 (a 16-bit row
    is then a multiple of the 16 bytes TMA moves, as is a float32 row for
    ``cp.async``; :func:`flash_attention` pads any other head_dim up to
    one; over 256 the wide kernel runs); contiguous tensors starting
    16-byte aligned."""
    if q.dtype not in _DTYPES:
        raise ValueError(f"K2 takes float32, bfloat16 or float16, not "
                         f"{q.dtype}")
    hd = q.shape[3]
    if hd % 8:
        raise ValueError(f"K2 takes a head_dim that is a multiple of 8, not "
                         f"{hd}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("K2 takes contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("K2 copies q, k, v 16 bytes at a time (TMA, "
                         "cp.async): they must start 16-byte aligned")


def pad_head_dim(q, k, v):
    """q, k, v zero-padded along the head dim up to a multiple of 8 (as
    they are where it is one).  The zero columns add nothing to Q K^T and
    give zero output columns, so attention over the padded tensors at the
    true head_dim's softmax scale, cut back to the true head_dim, is
    attention over q, k, v exactly."""
    pad = -q.shape[3] % 8
    if not pad:
        return q, k, v
    return tuple(torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))


def flash_attention(q, k, v, *, causal=True, window=None):
    """q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd) -> (B, H, Sq, hd), in q's
    type.  CPU tensors take :func:`flash_attention_plain`; CUDA tensors
    launch K2 (on q, k, v padded by :func:`pad_head_dim`, then what
    :func:`check_kernel_inputs` lets through) or raise."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA, not {q.device}")
    true_hd = q.shape[3]
    q, k, v = pad_head_dim(q, k, v)
    check_kernel_inputs(q, k, v)
    b, h, sq, hd = q.shape
    kv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out[..., :true_hd]
    lib = build()
    shape = (_DTYPES[q.dtype], b, h, kv, sq, sk, hd, int(causal),
             int(window is not None), int(window or 0),
             1.0 / math.sqrt(true_hd))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if hd > 256:                # the wide kernel: a grid of its own
            err = lib.k2_flash_attention_wide_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *shape, stream)
        else:
            items = _work_list(q.device, b, h, sq, sk, TILE[q.dtype],
                               bool(causal), window)
            taken = _counter(q.device, stream)
            err = lib.k2_flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                items.data_ptr(), taken.data_ptr(), items.numel(), *shape,
                stream)
    if err:
        raise RuntimeError(f"K2 launch failed: "
                           f"{lib.k2_error_string(err).decode()}")
    LAUNCHES[window] += 1
    return out if hd == true_hd else out[..., :true_hd]
