"""PolyBench kernels as OMP2MPI pragma programs with PyTorch bodies (the
paper's §4 / Fig. 6 set): the twin of ``benchmarks/polybench.py``.

The same 12 kernels in the same programs, names and bodies, written
against :mod:`repro_torch.omp`: the paper's Table 1 ``pi`` example, the
PolyBench/C 4.2.1 linear-algebra kernels ``gemm``, ``2mm``, ``3mm``,
``atax``, ``bicg``, ``mvt``, ``gesummv``, ``syrk``, ``syr2k`` and
``covariance``, and the stencil ``jacobi2d``.  Each builder returns a
:class:`PolyKernel`; its env is made with numpy from a seed
(:meth:`PolyKernel.numpy_env`), so the JAX package's programs can be fed
the very same arrays.

Sizes.  A builder's defaults are the reference's square ``n``;
:func:`make` with ``size="extralarge"`` gives the EXTRALARGE_DATASET
dims of PolyBench/C 4.2.1 (:data:`EXTRALARGE`), rectangular wherever the
body allows it:

* ``gemm`` C[NI, NJ] = 1.5 A[NI, NK] B[NK, NJ] + 1.2 C;
* ``2mm`` tmp[NI, NJ] = A[NI, NK] B[NK, NJ], D[NI, NL] = tmp C[NJ, NL] + D;
* ``3mm`` E[NI, NJ] = A B, F[NJ, NL] = C[NJ, NM] D[NM, NL], G[NI, NL] =
  E F (the second block runs NJ iterations, the others NI);
* ``atax`` A[M, N] (loops over the M rows; tmp[M], y[N]) and ``bicg``
  A[N, M] (loops over the N rows; q[N], s[M]);
* ``syrk`` / ``syr2k`` C[N, N] from A (and B) of [N, M] (the full
  symmetric product, as the reference computes it);
* ``covariance`` ``data`` holds the M = 2600 attributes as rows of N =
  3000 points (PolyBench's data[N][M] transposed, as the reference's
  body centres a row); C[M, M];
* ``mvt`` and ``gesummv`` are square in PolyBench too;
* ``jacobi2d`` B[i] = (A[i-1] + A[i+1] + roll(A[i], 1) + roll(A[i], -1))
  / 4 on the rows 1..N-2 of A[N, N] (``A`` read whole, so replicated):
  one sweep, where PolyBench runs TSTEPS = 1000 (the reference's builder
  runs one too), with its columns wrapped as the reference's body wraps
  them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import omp
from repro_torch.convert import env_from_numpy
from repro_torch.mesh import resolve_device


@dataclasses.dataclass
class PolyKernel:
    name: str
    programs: list            # list[ParallelFor] executed in order
    arrays: Callable[[np.random.Generator], dict]
    check_keys: tuple[str, ...]
    dims: dict                # problem dims actually used

    def numpy_env(self, seed: int = 0) -> dict:
        """The env as numpy arrays, drawn from ``seed``."""
        return self.arrays(np.random.default_rng(seed))

    def env_fn(self, device=None, seed: int = 0) -> dict:
        """The env as tensors on ``device`` (``None``: the CUDA card)."""
        return env_from_numpy(self.numpy_env(seed), resolve_device(device))


#: PolyBench/C 4.2.1 EXTRALARGE_DATASET dims (``*.h`` of each kernel).
EXTRALARGE = {
    "gemm": dict(ni=2000, nj=2300, nk=2600),
    "2mm": dict(ni=1600, nj=1800, nk=2200, nl=2400),
    "3mm": dict(ni=1600, nj=1800, nk=2000, nl=2200, nm=2400),
    "atax": dict(m=1800, n=2200),
    "bicg": dict(m=1800, n=2200),
    "mvt": dict(n=4000),
    "gesummv": dict(n=2800),
    "syrk": dict(m=2000, n=2600),
    "syr2k": dict(m=2000, n=2600),
    "covariance": dict(m=2600, n=3000),
    "jacobi2d": dict(n=2800),       # TSTEPS 1000 -> 1 sweep
}


def _rng(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.1)


def _zeros(*shape):
    return np.zeros(shape, np.float32)


def make_pi(n=2048):
    """Paper Table 1: sum[i] = 4/(1+x*x); total += sum[i]."""

    @omp.parallel_for(stop=n, schedule=omp.dynamic(), name="pi_fill")
    def fill(i, env):
        x = (i + 0.5) / n
        return {"sum": omp.at(i, 4.0 / (1.0 + x * x))}

    @omp.parallel_for(stop=n, reduction={"total": "+"}, name="pi_reduce")
    def reduce(i, env):
        return {"total": omp.red(env["sum"][i] / n)}

    def arrays(rng):
        return {"sum": _zeros(n), "total": np.float32(0)}

    return PolyKernel("pi", [fill, reduce], arrays, ("total",), dict(n=n))


def make_gemm(ni=192, nj=None, nk=None):
    nj, nk = nj or ni, nk or ni

    @omp.parallel_for(stop=ni, name="gemm")
    def gemm(i, env):
        row = 1.5 * (env["A"][i] @ env["B"]) + 1.2 * env["C"][i]
        return {"C": omp.at(i, row)}

    def arrays(rng):
        return {"A": _rng(rng, ni, nk), "B": _rng(rng, nk, nj),
                "C": _rng(rng, ni, nj)}

    return PolyKernel("gemm", [gemm], arrays, ("C",),
                      dict(ni=ni, nj=nj, nk=nk))


def make_2mm(ni=160, nj=None, nk=None, nl=None):
    nj, nk, nl = nj or ni, nk or ni, nl or ni

    @omp.parallel_for(stop=ni, name="mm1")
    def mm1(i, env):
        return {"tmp": omp.at(i, env["A"][i] @ env["B"])}

    @omp.parallel_for(stop=ni, name="mm2")
    def mm2(i, env):
        return {"D": omp.at(i, env["tmp"][i] @ env["C"] + env["D"][i])}

    def arrays(rng):
        return {"A": _rng(rng, ni, nk), "B": _rng(rng, nk, nj),
                "C": _rng(rng, nj, nl), "tmp": _zeros(ni, nj),
                "D": _rng(rng, ni, nl)}

    return PolyKernel("2mm", [mm1, mm2], arrays, ("D",),
                      dict(ni=ni, nj=nj, nk=nk, nl=nl))


def make_3mm(ni=128, nj=None, nk=None, nl=None, nm=None):
    nj, nk, nl, nm = nj or ni, nk or ni, nl or ni, nm or ni

    @omp.parallel_for(stop=ni, name="p1")
    def p1(i, env):
        return {"E": omp.at(i, env["A"][i] @ env["B"])}

    @omp.parallel_for(stop=nj, name="p2")
    def p2(i, env):
        return {"F": omp.at(i, env["C"][i] @ env["D"])}

    @omp.parallel_for(stop=ni, name="p3")
    def p3(i, env):
        return {"G": omp.at(i, env["E"][i] @ env["F"])}

    def arrays(rng):
        return {"A": _rng(rng, ni, nk), "B": _rng(rng, nk, nj),
                "C": _rng(rng, nj, nm), "D": _rng(rng, nm, nl),
                "E": _zeros(ni, nj), "F": _zeros(nj, nl),
                "G": _zeros(ni, nl)}

    return PolyKernel("3mm", [p1, p2, p3], arrays, ("G",),
                      dict(ni=ni, nj=nj, nk=nk, nl=nl, nm=nm))


def make_atax(m=512, n=None):
    n = n or m

    @omp.parallel_for(stop=m, name="ax")
    def ax(i, env):
        return {"tmp": omp.at(i, torch.dot(env["A"][i], env["x"]))}

    @omp.parallel_for(stop=m, reduction=None, name="aty")
    def aty(i, env):
        # y = A^T tmp computed row-wise via scatter of A[i]*tmp[i]
        return {"partial": omp.at(i, env["A"][i] * env["tmp"][i])}

    @omp.parallel_for(stop=m, reduction={"y": "+"}, name="fold")
    def fold(i, env):
        return {"y": omp.red(env["partial"][i])}

    def arrays(rng):
        return {"A": _rng(rng, m, n), "x": _rng(rng, n), "tmp": _zeros(m),
                "partial": _zeros(m, n), "y": _zeros(n)}

    return PolyKernel("atax", [ax, aty, fold], arrays, ("y",), dict(m=m, n=n))


def make_bicg(n=512, m=None):
    m = m or n

    @omp.parallel_for(stop=n, name="q")
    def q(i, env):
        return {"q": omp.at(i, torch.dot(env["A"][i], env["p"]))}

    @omp.parallel_for(stop=n, reduction={"s": "+"}, name="s")
    def s(i, env):
        return {"s": omp.red(env["A"][i] * env["r"][i])}

    def arrays(rng):
        return {"A": _rng(rng, n, m), "p": _rng(rng, m), "r": _rng(rng, n),
                "q": _zeros(n), "s": _zeros(m)}

    return PolyKernel("bicg", [q, s], arrays, ("q", "s"), dict(m=m, n=n))


def make_mvt(n=512):
    @omp.parallel_for(stop=n, name="x1")
    def x1(i, env):
        return {"x1": omp.at(i, env["x1"][i] + torch.dot(env["A"][i],
                                                         env["y1"]))}

    @omp.parallel_for(stop=n, reduction={"x2": "+"}, name="x2")
    def x2(i, env):
        return {"x2": omp.red(env["A"][i] * env["y2"][i])}

    def arrays(rng):
        return {"A": _rng(rng, n, n), "y1": _rng(rng, n), "y2": _rng(rng, n),
                "x1": _rng(rng, n), "x2": _zeros(n)}

    return PolyKernel("mvt", [x1, x2], arrays, ("x1", "x2"), dict(n=n))


def make_gesummv(n=384):
    @omp.parallel_for(stop=n, name="gesummv")
    def g(i, env):
        t = torch.dot(env["A"][i], env["x"])
        s = torch.dot(env["B"][i], env["x"])
        return {"y": omp.at(i, 1.5 * t + 1.2 * s)}

    def arrays(rng):
        return {"A": _rng(rng, n, n), "B": _rng(rng, n, n), "x": _rng(rng, n),
                "y": _zeros(n)}

    return PolyKernel("gesummv", [g], arrays, ("y",), dict(n=n))


def make_syrk(n=160, m=None):
    m = m or n

    @omp.parallel_for(stop=n, name="syrk")
    def syrk(i, env):
        return {"C": omp.at(i, 1.2 * env["C"][i]
                            + 1.5 * env["A"][i] @ env["A"].T)}

    def arrays(rng):
        return {"A": _rng(rng, n, m), "C": _rng(rng, n, n)}

    return PolyKernel("syrk", [syrk], arrays, ("C",), dict(m=m, n=n))


def make_syr2k(n=128, m=None):
    m = m or n

    @omp.parallel_for(stop=n, name="syr2k")
    def syr2k(i, env):
        v = env["A"][i] @ env["B"].T + env["B"][i] @ env["A"].T
        return {"C": omp.at(i, 1.2 * env["C"][i] + 1.5 * v)}

    def arrays(rng):
        return {"A": _rng(rng, n, m), "B": _rng(rng, n, m),
                "C": _rng(rng, n, n)}

    return PolyKernel("syr2k", [syr2k], arrays, ("C",), dict(m=m, n=n))


def make_covariance(m=192, n=None):
    n = n or m

    @omp.parallel_for(stop=m, name="center")
    def center(i, env):
        col = env["data"][i]
        return {"centered": omp.at(i, col - torch.mean(col))}

    @omp.parallel_for(stop=m, name="cov")
    def cov(i, env):
        return {"C": omp.at(i, env["centered"] @ env["centered"][i]
                            / (env["centered"].shape[1] - 1))}

    def arrays(rng):
        return {"data": _rng(rng, m, n), "centered": _zeros(m, n),
                "C": _zeros(m, m)}

    return PolyKernel("covariance", [center, cov], arrays, ("C",),
                      dict(m=m, n=n))


def make_jacobi2d(n=256):
    """Stencil: reads rows i-1, i, i+1 of A whole (the replicate path),
    the row's columns wrapped by ``torch.roll``."""

    @omp.parallel_for(start=1, stop=n - 1, name="jacobi")
    def jac(i, env):
        a = env["A"]
        row = 0.25 * (a[i - 1] + a[i + 1] + torch.roll(a[i], 1)
                      + torch.roll(a[i], -1))
        return {"B": omp.at(i, row)}

    def arrays(rng):
        return {"A": _rng(rng, n, n), "B": _zeros(n, n)}

    return PolyKernel("jacobi2d", [jac], arrays, ("B",), dict(n=n))


ALL_KERNELS = [
    make_pi, make_gemm, make_2mm, make_3mm, make_atax, make_bicg,
    make_mvt, make_gesummv, make_syrk, make_syr2k, make_covariance,
    make_jacobi2d,
]

BUILDERS = {build.__name__[len("make_"):]: build for build in ALL_KERNELS}

#: The stencils (PolyBench's ``stencils`` directory).
STENCILS = ("jacobi2d",)
#: The linear-algebra kernels (every kernel but ``pi`` and the stencils).
LINEAR_ALGEBRA = tuple(k for k in EXTRALARGE if k not in STENCILS)


def make(name: str, size="extralarge") -> PolyKernel:
    """Kernel ``name`` at ``size``: ``"extralarge"`` (PolyBench/C 4.2.1
    EXTRALARGE_DATASET dims; ``pi`` keeps its default n), a dict of dims,
    or an int (square, as the reference's ``n``)."""
    build = BUILDERS[name]
    if size == "extralarge":
        return build(**EXTRALARGE.get(name, {}))
    if isinstance(size, dict):
        return build(**size)
    return build(int(size))
