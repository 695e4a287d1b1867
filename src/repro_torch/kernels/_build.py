"""Build a CUDA C++ kernel of the port with ``nvcc`` and load it with
``ctypes`` — shared by the hand-written kernels (K2, K3).

At first use :meth:`CudaLibrary.load` compiles the kernel's one source
file with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`` into ``build/kernels/<name>_<hash>.so`` (the hash
covers the source and the flags, so an edited source builds anew) and
loads it; a later call returns the loaded library.  Builds of different
kernels may run in threads side by side; one kernel builds once.
"""
from __future__ import annotations

import ctypes
import hashlib
import subprocess
import threading
from pathlib import Path
from typing import Callable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc(tag: str) -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(f"{tag} needs nvcc: no CUDA toolkit found "
                           "(set CUDA_HOME)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


class CudaLibrary:
    """One kernel's shared library: its source under ``csrc/``, the tag
    its errors carry (``"K2"``), and ``bind(lib)``, which sets the C
    entries' ``argtypes``/``restype``.  :attr:`log` holds what nvcc
    printed for the last build (ptxas registers, spills, shared memory)."""

    def __init__(self, source: str, tag: str,
                 bind: Callable[[ctypes.CDLL], None]) -> None:
        self.source = CSRC / source
        self.tag = tag
        self._bind = bind
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()
        self.log = ""

    def load(self) -> ctypes.CDLL:
        """Compile the kernel (once per source and flags) and load it."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            text = self.source.read_bytes()
            key = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode())
            lib_path = (BUILD_DIR
                        / f"{self.source.stem}_{key.hexdigest()[:16]}.so")
            if not lib_path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = lib_path.with_suffix(f".{threading.get_ident()}.tmp")
                proc = subprocess.run(
                    [nvcc(self.tag), *NVCC_FLAGS, "-o", str(tmp),
                     str(self.source)], capture_output=True, text=True)
                self.log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed to build {self.tag}:\n{self.log}")
                tmp.replace(lib_path)
            lib = ctypes.CDLL(str(lib_path))
            self._bind(lib)
            self._lib = lib
            return lib
