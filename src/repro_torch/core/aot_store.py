"""Persistent AOT store — the compile cache that survives the process
(counterpart of :mod:`repro.core.aot_store`).

The structural compilation cache of :mod:`repro_torch.core.api` dies
with the process: every fresh worker plans again and, under the kernel
lowering, has Triton compile every span kernel again (a cold K1 build of
PolyBench ``gemm`` takes about a second on the H100).  This store keeps
what an executor is built from, as data, in a versioned on-disk store:
the planned artifacts (the plan, and the ``kernel`` pass's
:class:`~repro_torch.core.kernel_lower.KernelPlan` with each span's
generated source) and, on the card, the cubin Triton compiled for each
span kernel with the launch metadata K1's launcher needs.  A fresh
process restores them instead of planning and compiling.  The port has
no XLA executable to serialize, which is what the reference's entries
hold.

Keys must be stable *across processes*, which the in-memory cache key
is not (it pins loop bodies by ``id()``).  :func:`fingerprint` derives a
structural content hash instead: function bodies hash by bytecode +
consts + closure values (recursively; nested code objects hash by
structure, never by ``repr``, which embeds addresses), arrays and
tensors by shape, dtype and bytes.  Data-only parts hash as the
reference's :func:`repro.core.aot_store.fingerprint` hashes them.

Robustness contract: a corrupt, truncated, version-skewed or otherwise
unreadable entry is a *miss*, never a crash; the caller builds cold and
the store counts the error.  Writes are atomic (temp file + rename), so
a concurrent reader never sees a partial entry.

Entry layout (one file per key, ``<key>.aot``)::

    MAGIC | u32 header_len | header JSON | sha256(body) | body

The header records the store version, the torch version, the Triton
version where Triton is installed, and the device (``cpu``, or the CUDA
card's ``sm_<major><minor>``); any mismatch is a miss.  The body is what
the caller hands :meth:`AOTStore.save` (bytes); :meth:`AOTStore.load`
hands it to the caller's decoder, and a decoder that raises makes the
entry a counted miss too.
"""
from __future__ import annotations

import dataclasses
import enum
import hashlib
import importlib.metadata
import json
import os
import struct
import tempfile
import types
from typing import Any, Callable

import numpy as np
import torch

STORE_VERSION = 1
_MAGIC = b"RPROAOT\x01"

#: Environment variable naming the store directory; when set, the
#: compile pipeline (:mod:`repro_torch.core.api`) enables persistence at
#: import.
ENV_VAR = "REPRO_AOT_CACHE_DIR"

#: Optional size cap (bytes) on the store directory.  When set (here or
#: through ``max_bytes=``), every save sweeps least-recently-*used*
#: entries (mtime order; load hits touch the file) until the directory
#: fits.  Unset, invalid or <= 0 means unbounded.
ENV_MAX_BYTES = "REPRO_AOT_CACHE_MAX_BYTES"


# ---------------------------------------------------------------------------
# Stable structural fingerprints
# ---------------------------------------------------------------------------


def _code_token(code: types.CodeType, seen: set) -> tuple:
    """Structural identity of a code object (its ``repr`` embeds an
    address): the fields that define its behaviour."""
    return ("code", code.co_name, code.co_argcount, code.co_nlocals,
            code.co_code, _token(code.co_consts, seen),
            code.co_names, code.co_varnames, code.co_freevars)


def _function_token(fn, seen: set) -> tuple:
    key = id(fn)
    if key in seen:
        return ("recursive-fn", fn.__qualname__)
    seen = seen | {key}
    closure = ()
    if fn.__closure__:
        closure = tuple(_token(c.cell_contents, seen)
                        for c in fn.__closure__)
    return ("fn", fn.__module__, fn.__qualname__,
            _code_token(fn.__code__, seen),
            _token(fn.__defaults__, seen), closure)


def _tensor_token(t: torch.Tensor) -> tuple:
    """A tensor as the reference tokens an array: shape, dtype name and
    the sha256 of its bytes (on the host)."""
    flat = t.detach().to("cpu").contiguous().reshape(-1)
    raw = flat.view(torch.uint8).numpy().tobytes() if flat.numel() else b""
    return ("array", tuple(t.shape), str(t.dtype).replace("torch.", ""),
            hashlib.sha256(raw).hexdigest())


def _token(v: Any, seen: set) -> Any:
    """A repr-stable token for ``v``: equal program structure gives an
    equal token in every process; addresses never leak in."""
    if v is None or isinstance(v, (bool, int, float, complex, str, bytes)):
        return v
    if isinstance(v, enum.Enum):
        return ("enum", type(v).__name__, v.value)
    if isinstance(v, types.CodeType):
        return _code_token(v, seen)
    if isinstance(v, types.FunctionType):
        return _function_token(v, seen)
    if isinstance(v, torch.Tensor):
        return _tensor_token(v)
    if hasattr(v, "shape") and hasattr(v, "dtype"):
        arr = np.asarray(v)
        return ("array", arr.shape, str(arr.dtype),
                hashlib.sha256(arr.tobytes()).hexdigest())
    if isinstance(v, (tuple, list)):
        return (type(v).__name__,) + tuple(_token(x, seen) for x in v)
    if isinstance(v, dict):
        return ("dict",) + tuple(
            (_token(k, seen), _token(v[k], seen))
            for k in sorted(v, key=repr))
    if isinstance(v, (set, frozenset)):
        return ("set",) + tuple(sorted(repr(_token(x, seen)) for x in v))
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return ("dc", type(v).__name__) + tuple(
            (f.name, _token(getattr(v, f.name), seen))
            for f in dataclasses.fields(v))
    # Type identity only: a bare repr may embed an address
    # (``<object at 0x...>``), which would defeat cross-process reuse.
    r = repr(v)
    return ("obj", type(v).__name__, r if " at 0x" not in r else "")


def fingerprint(*parts: Any) -> str:
    """SHA-256 hex digest of the stable token of ``parts``."""
    tok = _token(tuple(parts), set())
    return hashlib.sha256(repr(tok).encode()).hexdigest()


# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------


def empty_stats() -> dict:
    return {"disk_hits": 0, "disk_misses": 0, "disk_errors": 0,
            "disk_bytes_read": 0, "disk_bytes_written": 0,
            "evictions": 0, "evicted_bytes": 0}


def device_tag(device) -> str:
    """The header's device: ``cpu``, or a CUDA card's ``sm_<cc>`` (a
    cubin runs only on its own architecture)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    major, minor = torch.cuda.get_device_capability(device)
    return f"sm_{major}{minor}"


def _triton_version() -> str | None:
    """Triton's version where it is installed (read from its metadata:
    nothing is imported), else None."""
    try:
        return importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        return None


class AOTStore:
    """One directory of stored compiles, one file per key.

    ``load``/``save`` never raise on a bad entry or an unwritable
    directory: persistence is an accelerator, not a correctness
    dependency, and every failure is counted in :attr:`stats`."""

    def __init__(self, path: str, max_bytes: int | None = None) -> None:
        self.path = os.path.abspath(os.path.expanduser(path))
        os.makedirs(self.path, exist_ok=True)
        self.stats = empty_stats()
        if max_bytes is None:
            raw = os.environ.get(ENV_MAX_BYTES, "")
            try:
                max_bytes = int(raw) if raw else None
            except ValueError:
                max_bytes = None
        self.max_bytes = (max_bytes
                          if max_bytes is not None and max_bytes > 0
                          else None)

    # -- key -> file -------------------------------------------------------

    def _entry_path(self, key: str) -> str:
        return os.path.join(self.path, f"{key}.aot")

    def _header(self, key: str, device) -> dict:
        return {"store_version": STORE_VERSION, "key": key,
                "torch": torch.__version__, "triton": _triton_version(),
                "device": device_tag(device)}

    def entries(self) -> list[str]:
        try:
            return sorted(f[:-4] for f in os.listdir(self.path)
                          if f.endswith(".aot"))
        except OSError:
            return []

    # -- save --------------------------------------------------------------

    def save(self, key: str, body: bytes, device="cpu") -> bool:
        """Store ``body`` under ``key`` for ``device``.  Returns whether
        the entry landed on disk."""
        try:
            header = json.dumps(self._header(key, device)).encode()
            blob = (_MAGIC + struct.pack("<I", len(header)) + header
                    + hashlib.sha256(body).digest() + body)
            fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as fh:
                    fh.write(blob)
                os.replace(tmp, self._entry_path(key))
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        except Exception:
            self.stats["disk_errors"] += 1
            return False
        self.stats["disk_bytes_written"] += len(blob)
        self._evict(protect=key)
        return True

    # -- eviction ----------------------------------------------------------

    def _evict(self, protect: str | None = None) -> None:
        """LRU sweep: drop the oldest entries by mtime until the directory
        fits :attr:`max_bytes`.  The just-written ``protect`` key is never
        dropped (a cap smaller than one entry must not turn every save
        into its own eviction).  A file vanishing or failing mid-sweep is
        tolerated, never raised."""
        if self.max_bytes is None:
            return
        try:
            names = os.listdir(self.path)
        except OSError:
            return
        entries, total = [], 0
        for f in names:
            if not f.endswith(".aot"):
                continue
            p = os.path.join(self.path, f)
            try:
                st = os.stat(p)
            except OSError:
                continue
            entries.append((st.st_mtime, st.st_size, p, f[:-4]))
            total += st.st_size
        entries.sort()
        for _mtime, size, p, k in entries:
            if total <= self.max_bytes:
                break
            if k == protect:
                continue
            try:
                os.unlink(p)
            except OSError:
                continue
            total -= size
            self.stats["evictions"] += 1
            self.stats["evicted_bytes"] += size

    # -- load --------------------------------------------------------------

    def load(self, key: str, device="cpu",
             decode: Callable[[bytes], Any] = bytes):
        """``decode(body)`` of the entry for ``key`` on ``device``, or
        None on a miss.  A corrupt, truncated or version-skewed entry, or
        one ``decode`` refuses (raises), counts as a miss and an error,
        and the bad file is removed so that it is not probed again."""
        path = self._entry_path(key)
        try:
            with open(path, "rb") as fh:
                blob = fh.read()
        except OSError:
            self.stats["disk_misses"] += 1
            return None
        try:
            if blob[:len(_MAGIC)] != _MAGIC:
                raise ValueError("bad magic")
            off = len(_MAGIC)
            (hlen,) = struct.unpack_from("<I", blob, off)
            off += 4
            header = json.loads(blob[off:off + hlen].decode())
            off += hlen
            want = self._header(key, device)
            for field in ("store_version", "torch", "triton", "device"):
                if header.get(field) != want[field]:
                    raise ValueError(
                        f"version skew: {field}={header.get(field)!r} "
                        f"(want {want[field]!r})")
            digest, body = blob[off:off + 32], blob[off + 32:]
            if len(digest) != 32 or hashlib.sha256(body).digest() != digest:
                raise ValueError("checksum mismatch")
            out = decode(body)
        except Exception:
            self.stats["disk_errors"] += 1
            self.stats["disk_misses"] += 1
            try:
                os.unlink(path)
            except OSError:
                pass
            return None
        self.stats["disk_hits"] += 1
        self.stats["disk_bytes_read"] += len(blob)
        try:
            os.utime(path)               # refresh LRU recency on a hit
        except OSError:
            pass
        return out
