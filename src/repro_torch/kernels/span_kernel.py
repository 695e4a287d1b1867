"""K1 — the span kernel: the loop bodies of a span (one block, or a chain
of exchange-free region stages) on every lane of every rank's chunks, in
ONE Triton launch for Hopper (``sm_90a``).

Replaces ``src/repro/core/pallas_lower.py::execute_span`` (its
``pl.pallas_call``), which ran once per device over that device's slab.

Bound: device-memory bytes for pointwise bodies, float32 operations for
matrix products.  A pointwise body does a few flops per byte, far below
the H100's float32 ridge (67 TFLOP/s over 3.35 TB/s, about 20 flops per
byte), so the design keeps every access coalesced (lanes of a tile are
consecutive iterations, the last nest axis fastest) and fuses the whole
body into one pass: no intermediate ever leaves registers.  A first
version makes no attempt at shared-memory staging of halo windows: a
stencil's neighbouring lanes load overlapping taps straight from the
slab and the overlap is left to L1/L2.  A row-times-matrix body
(PolyBench's ``gemm``, ``syrk``, ``covariance``) does 2K flops for each
value it stores and is bound by operations: its product runs on
``tl.dot`` over ``[lanes, BK] x [BK, BN]`` tiles, K-looped, accumulating
in float32, on the tensor cores — three TF32 products for float32
operands (``input_precision="tf32x3"``: within a few float32 roundings,
where one TF32 product keeps three digits), 16-bit ones as they are —
and its output's value axis is split over the grid so that enough
programs fill the card.  A matrix whose tiles run the other way than the
dot reads them fastest is handed to the kernel as a copy of its
transpose (:func:`kernel_args`): the tensor cores take a float32 B tile
K-major.  A matrix-vector body (``atax``, ``bicg``, ``mvt``,
``gesummv``) does 2 flops for each matrix value it reads and is bound by
bytes: its rows are multiplied by the vector and summed in float32 over
wide K tiles, a few rows a program, so that every SM keeps many tiles in
flight.

The body is user code, so the kernel is a template plus a generator, as
the Pallas kernel traced the body into its own body:

* :data:`PROLOGUE1` / :data:`PROLOGUE2` (hand-written) decompose the
  program id into (value tile, chunk slot, tile) — one slot per (local
  chunk, rank), so all virtual ranks share the launch — and compute
  every lane's iteration, clamped to ``trip - 1`` past the trip count.
  The grid covers only the slots that hold an iteration
  (:func:`live_slots`), so the chunk plan's padding slots are neither
  launched nor stored; the lanes past the trip in the last slot of an
  axis compute the clamped iteration and are stored, as in the Pallas
  kernel (no merge reads them).  A mask on the trip count there cost
  ``heat2d`` about 30% (PERF.md);
* :class:`_Gen` walks the aten graph of ``vmap(body)``
  (:func:`repro_torch.core.context.trace_body`) and emits ``tl`` code per
  op: affine loads from the slab windows (row ``index - (k0 +
  halo_base)``) or from replicated arrays, pointwise arithmetic,
  ``sum``/``mean``/``amax``/``amin`` over a per-lane value axis, a
  ``cumsum`` along it (``tl.cumsum`` of a tile in float32, the running
  sum carried from tile to tile where the axis is tiled, a tile of the
  grid's value axis starting from the sum before it, a rolled scan
  scanned again in two segments), a ``roll``
  along it (the rolled value emitted again at the wrapped positions; a
  lane scalar's roll is the identity), ``aten.mm`` of a per-lane
  operand and a replicated array (either side, transposed or not, a
  step-1 slice of it read in place) as K-loops of ``tl.dot`` and
  ``aten.mv`` as K-loops of row sums — so is a product one position
  wide (a one-column matrix, one position of a wider output), and a
  product of integer operands is row sums in their integer type, which
  wrap as ``jnp.dot``'s do (``tl.dot`` takes floats); a rank-2
  nest's ``A[i] . B[:, j]`` is the outer tile ``A[tile_i, K] @ B[K,
  tile_j]``.  Lane scalars are emitted once, in order; a value with a
  per-lane value axis is emitted per value *tile* where it is consumed
  (:class:`_Scope`): the whole axis in one register tile when it fits
  (:data:`_MAX_TILE_ELEMS`), else a loop over tiles (a reduction's first
  pass, a product's K-loop, a store), or the grid's value tile;
* the epilogue stores the dense values, masked, in the global slab
  layout ``(n_loc, P, c, *value_shape)``.

**A rank window.**  On a :class:`~repro_torch.mesh.ProcessMesh` a
process launches the kernel over its own ranks ``lo .. lo + block - 1``
of the first nest axis only: :func:`generate_span` with ``block`` writes
a kernel whose slabs and dense outputs are ``(n_loc, block, c, ...)``
(rank 2: the ``i`` axis's ranks), whose prologue maps a program's local
slot ``s`` to the global slot ``(s // block) * P + lo + s % block`` (so
iteration numbers and window offsets stay global, and addresses local),
and which reads ``lo`` from a one-element int32 tensor, its first
argument: every process runs one source and one compiled kernel.  Its
grid covers the live local slots of the window with the most (a window
with fewer runs the rest on padding slots, which no merge reads).
``block`` equal to ``P`` (a stacked mesh) generates the source it always
did, character for character.

A span of several stages (:func:`generate_span`) is one function: one
prologue, then the stages' bodies in span order, each storing all its
written keys (the merges outside need them).  A key an earlier stage of
the span wrote (identity/partial) and a later stage reads through a
resident feed is *forwarded*: the later stage reads the register tile
the earlier one stored for the same lanes, never a reload from device
memory.  The generator serves a forwarded read only when it provably
addresses the lane's own row — the index is ``k + base`` on every
sharded axis for the lane's iteration ``k`` and the producer's write
``base`` (tracked through the aten graph as an affine form of the
iterator) — and raises ``CompileError`` otherwise.  A later stage that
reads such a tile in another tiling (a ``roll``'s wrapped positions)
emits the producer's value again there (``_Val.alt``): the earlier stage
computed it from values the kernel still holds or loads, so no barrier
and no read-back of stored rows is needed.  All stages share one chunk
geometry, so one tile and one grid (checked, not assumed).

An op outside the template raises ``CompileError`` naming it, when the
program compiles.  The source is written to ``build/span_kernels/`` and
imported from there (``@triton.jit`` reads its source from disk); Triton
caches its builds under ``build/triton/``.  Triton is imported only
when a kernel launches, so this module imports on machines without it.

:func:`span_stage_values` is the wrapper, for a block's one-stage span
and a region's span alike: CPU tensors take
:func:`span_values_plain_stages` (the same function in plain PyTorch —
each stage's body vmapped over lanes by :func:`span_values_plain`,
forwarded values handed over as tensors); CUDA tensors launch the kernel
or raise.  :data:`LAUNCHES` counts launches, one per span.

The launch (:class:`_Launcher`, built per source at its first launch)
skips Triton's Python launch path, whose binder, specialisation and
cache lookup cost more host time than a short span's device time: it
keeps the compiled kernel of each pointer-alignment specialisation met
(compiled through Triton's own path on a miss), allocates the outputs as
16-byte aligned views into one buffer, and enqueues with one C call
(``csrc/span_launch.cu``: ``cuLaunchKernel`` of the same cubin).
:func:`launch_span_triton` keeps the old launch, to hold the new one
against it.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import importlib.util
import math
import operator
import os
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.core import context as ctx_mod
from repro_torch.core.api import CompileError
from repro_torch.core.nest import (derive_nest_tiles, pow2_at_least,
                                   window_extent)
from repro_torch.kernels import _build

aten = torch.ops.aten

#: Kernel launches so far (one per span launched on CUDA).
LAUNCHES = 0

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

#: Lane-vector sizes of the second trace: a graph dim whose size differs
#: between the two traces is a lane dim, one that keeps it a value dim.
_LANES_B = (11, 13)

#: Largest register tile of one value: lanes x value tile.  A per-lane
#: value axis whose padded length fits is held whole; a longer one is
#: tiled (loops, or the grid's value axis).
_MAX_TILE_ELEMS = 1 << 12

#: ``tl.dot`` takes tiles of at least 16 on every dim.
_DOT_MIN = 16
#: Lanes of a tile (per axis) in a span with a row-times-matrix product;
#: the grid's value tile over its output takes ``_DOT_TILE_SCALE`` x
#: :data:`_MAX_TILE_ELEMS` accumulators a tile: a 128 x 128 ``wgmma``
#: output tile a program, 8 warps, a 3-stage operand ring.
_DOT_LANES = 128
_DOT_TILE_SCALE = 4
_DOT_WARPS = 8
_DOT_STAGES = 3
#: Shared memory a block may hold on the H100 (227 KB, opted in).  A
#: product's ring takes one ``[lanes, BK]`` and one ``[BK, N]`` operand
#: tile a stage; where ``_DOT_STAGES`` of them do not fit here, the K
#: tile is halved until they do (:meth:`_Gen._k_loop`; a tile of 16 lanes
#: and 1024 values still fits at 16).  Phase 18's cumsum1 (32 lanes, a
#: 512-wide output tile) so runs K tiles of 32: at 64 its three stages
#: need 288 KB, and one or two stages ran 20x slower than K tiles of 32
#: or 16 at three (``tools/k1_product_variants.py ring``).
_SMEM_BYTES = 232448
#: Precision of a ``tl.dot`` of float32 operands: three TF32 products
#: (``a_hi b_hi + a_hi b_lo + a_lo b_hi``) on the tensor cores, within a
#: few float32 roundings of the IEEE product.  Every float32 ``tl.dot``
#: states it, so a bare (one-product) TF32 dot never occurs.
_F32_PRECISION = "tf32x3"
#: Lanes of a tile in a span whose products give one value a lane
#: (matrix-vector): a product is a multiply and a row sum over K tiles of
#: ``_BK_MV`` values (no ``tl.dot``, whose 16-column minimum would
#: multiply the work by 16), the vector tile loaded once a K step for
#: all the program's lanes; few lanes, so that several programs share
#: each SM, and a K loop whose loads Triton pipelines ``_MV_STAGES``
#: deep (``tl.range``), so that each keeps tiles in flight.
_MV_LANES = 4
_BK_MV = 1024
_MV_WARPS = 4
_MV_STAGES = 3
#: Lanes of a tile in a span without products whose value axes are too
#: long for the default tile: a few rows a program, each swept in wide
#: value tiles, so that the grid holds several programs an SM.
_LONG_LANES = 4
#: Rank-2 outer tile: lanes per axis at most.
_DOT2_LANES = 32
#: K-loop depth of a matrix product: ``_BK_ONE`` where the span holds one
#: product, ``_BK`` where it holds more (syr2k's two products ran 1.18x
#: slower at 64; one product 1.03-1.15x faster at 64 than at 32 on the
#: H100, ``tools/k1_product_variants.py``).
_BK_ONE = 64
_BK = 32

#: Element count from which offsets are computed in 64 bits (a margin
#: below 2^31 for window halos and padded values).
_WIDE_ELEMS = 1 << 29

NUM_WARPS = 4

_PRODUCTS = (aten.mm.default, aten.mv.default)
#: Views on a per-lane value: the template keeps one lane-major tile per
#: value whatever the view (``squeeze_`` comes from vmap's ``@`` rule).
_VIEWS = ctx_mod.VIEW_OPS | {aten.squeeze_.dims, aten.squeeze_.dim,
                             aten.unsqueeze_.default}
_MEM_VIEWS = (aten.t.default, aten.permute.default, aten.transpose.int)


#: The scans along a per-lane value axis, by the aten op that asks for
#: one: sums and products are Triton's own scans, the others
#: ``tl.associative_scan`` with a combine function of
#: :data:`_COMBINERS`.
_SCAN_OPS = {"sum": "aten.cumsum", "prod": "aten.cumprod",
             "max": "aten.cummax", "min": "aten.cummin",
             "lse": "aten.logcumsumexp"}

#: ``@triton.jit`` combine functions of the associative scans, placed in
#: a generated source that uses them: max and min keep a float NaN, as
#: ``torch.cummax``/``cummin`` and ``lax.cummax`` do; log-add-exp gives
#: ``-inf`` (never NaN) where both sides are ``-inf``, and ``+inf`` where
#: both are ``+inf``, as ``torch.logcumsumexp`` does.
_COMBINERS = {
    "_scan_maxf": "    return tl.maximum(a, b, propagate_nan="
                  "tl.PropagateNan.ALL)\n",
    "_scan_minf": "    return tl.minimum(a, b, propagate_nan="
                  "tl.PropagateNan.ALL)\n",
    "_scan_maxi": "    return tl.maximum(a, b)\n",
    "_scan_mini": "    return tl.minimum(a, b)\n",
    "_scan_lse": (
        "    hi = tl.maximum(a, b, propagate_nan=tl.PropagateNan.ALL)\n"
        "    lo = tl.minimum(a, b, propagate_nan=tl.PropagateNan.ALL)\n"
        "    return tl.where((lo != hi) | (tl.abs(lo) < float(\"inf\")),\n"
        "                    hi + libdevice.log1p(tl.exp(lo - hi)), a)\n"),
}


@dataclasses.dataclass(frozen=True)
class _Scan:
    """Scan ``op`` (a key of :data:`_SCAN_OPS`) in type ``at``: its
    expression over a tile, the identity a masked position holds, and how
    two partial results combine."""

    op: str
    at: Any

    @property
    def fn(self) -> str | None:
        """The combine function of an associative scan (None: Triton's
        own sum or product scan)."""
        if self.op in ("sum", "prod"):
            return None
        if self.op == "lse":
            return "_scan_lse"
        return f"_scan_{self.op}{'f' if self.at.is_floating_point else 'i'}"

    def scan(self, e: str, axis: int = 1) -> str:
        if self.op == "sum":
            return f"tl.cumsum({e}, axis={axis})"
        if self.op == "prod":
            return f"tl.cumprod({e}, axis={axis})"
        return f"tl.associative_scan({e}, {axis}, {self.fn})"

    @property
    def ident(self) -> str:
        if self.op in ("sum", "prod"):
            return "0" if self.op == "sum" else "1"
        if self.at.is_floating_point:
            return 'float("inf")' if self.op == "min" else '-float("inf")'
        info = torch.iinfo(self.at)
        return str(info.max if self.op == "min" else info.min)

    def comb(self, a: str, b: str) -> str:
        if self.op == "sum":
            return f"({a} + {b})"
        if self.op == "prod":
            return f"({a} * {b})"
        return f"{self.fn}({a}, {b})"

_TL = {
    torch.float32: "tl.float32", torch.float16: "tl.float16",
    torch.bfloat16: "tl.bfloat16", torch.float64: "tl.float64",
    torch.int32: "tl.int32", torch.int64: "tl.int64",
    torch.int16: "tl.int16", torch.int8: "tl.int8", torch.uint8: "tl.uint8",
    torch.bool: "tl.int1",
}


PROLOGUE1 = """\
    pid = tl.program_id(0){wide}
{vsplit}    slot = pid // {nt}
    tile = pid - slot * {nt}
{window}    lane = tile * {tile} + tl.arange(0, {tile})[:, None]
    it = {gslot} * {c} + lane
    lmask = lane < {c}
    i0 = ({start} + {step} * tl.minimum(it, {tmax})).to(tl.int32)
"""

PROLOGUE2 = """\
    pid = tl.program_id(0){wide}
{vsplit}    tj = pid % {ntj}
    r = pid // {ntj}
    sj = r % {nsj}
    r = r // {nsj}
    ti = r % {nti}
    si = r // {nti}
{window}    f = tl.arange(0, {lanes})[:, None]
    li = ti * {ti} + f // {tj}
    lj = tj * {tj} + f % {tj}
    iti = {gslot} * {ci} + li
    itj = sj * {cj} + lj
    lmask = (li < {ci}) & (lj < {cj})
    i0 = ({starti} + {stepi} * tl.minimum(iti, {tmaxi})).to(tl.int32)
    j0 = ({startj} + {stepj} * tl.minimum(itj, {tmaxj})).to(tl.int32)
"""

#: A rank window's global slot of local slot ``{s}`` (``rank_lo``: the
#: window's first rank, the kernel's first argument).
WINDOW = """\
    {g} = {s} // {block} * {p} + tl.load(rank_lo) + {s} % {block}
"""

#: The value tile of a program, first in the program id, so that the
#: programs of one lane tile run side by side and share its rows in L2.
VSPLIT = """\
    vt = pid % {nv}
    pid = pid // {nv}
"""


@dataclasses.dataclass(frozen=True)
class SpanSource:
    """One generated span kernel and how to call it."""

    fn_name: str
    text: str
    inputs: tuple            # ("win" | "repl" | "replT", stage, key) per
    #                          pointer arg (see kernel_args)
    outputs: tuple           # (stage, key, global shape, dtype) per output
    n_programs: int
    flops_per_lane: int      # arithmetic ops per real lane (for the bound)
    dot_flops_per_lane: int = 0  # of which on ``tl.dot`` (matrix products)
    forwarded: tuple = ()    # (stage, key): reads served from a register
    tiles: tuple = ()        # AxisTiles per nest axis (the lanes of a tile)
    value_tiles: int = 1     # programs per lane tile (the grid's value axis)
    num_warps: int = NUM_WARPS
    num_stages: int = 3      # the launch's software-pipelining depth
    window: tuple = ()       # (block, P): a rank window's kernel (lo is
    #                          its first argument); () for every rank


# ---------------------------------------------------------------------------
# Code generation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Mem:
    """An env buffer, possibly with constant positions selected;
    ``remaining`` lists its other dims in the order the body sees them
    (a transpose reorders it)."""

    key: str
    shape: tuple
    fixed: dict
    remaining: list
    dtype: Any = None           # the type the body casts it to (None: its own)
    # dims the body slices with step 1: dim -> (first position, length)
    starts: dict = dataclasses.field(default_factory=dict)

    def extent(self, d: int) -> int:
        return self.starts[d][1] if d in self.starts else self.shape[d]


@dataclasses.dataclass
class _Val:
    expr: str | None = None
    dtype: Any = None
    lane: bool = False          # varies across lanes
    k: int | None = None        # length of the per-lane value axis
    const: Any = None           # a Python number (inline literal)
    mem: _Mem | None = None
    aff: tuple | None = None    # (axis, a, b): exactly a * iterator + b
    lazy: Any = None            # k-valued: emits one tile in a _Scope
    loop: bool = False          # its tile is computed by a K-loop
    scope: Any = None           # the _Scope ``expr`` lies in (None: any)
    src: tuple | None = None    # a row load: (mem, {dim: index}, value dim)
    alt: Any = None             # a register tile's lazy twin (other tilings)
    scan: tuple | None = None   # a cumsum's (operand, sum type)


@dataclasses.dataclass
class _Scope:
    """A tile of a per-lane value axis of ``length``: positions ``r``
    (``[1, bt]``, or ``[1, 1]`` for one position) under mask ``m``, and
    the values already emitted for it (``cache``, by lazy emitter)."""

    length: int
    r: str
    m: str
    bt: int
    start: str | None = None    # the tile's first position (a loop's
    #                             variable, the grid's value tile)
    cache: dict = dataclasses.field(default_factory=dict)
    seq: bool = False           # positions start + arange(bt), tiles in order
    pre: tuple | None = None    # a loop's (lines before it, their indent)


def _flat(lines: list) -> list[str]:
    """Generated lines in order, the lists placed before loops opened."""
    return [x for item in lines
            for x in (_flat(item) if isinstance(item, list) else (item,))]


def _nan_arg(dtype) -> str:
    """``tl.maximum``/``tl.minimum``'s NaN rule for ``dtype``: a float NaN
    comes out as NaN, as in ``torch.clamp``/``torch.maximum`` and
    ``jnp.clip`` (Triton's default returns the other operand)."""
    return (", propagate_nan=tl.PropagateNan.ALL"
            if dtype.is_floating_point else "")


def _lit(v, dtype) -> str:
    if dtype == torch.bool:
        return "True" if v else "False"
    if dtype is not None and (dtype.is_floating_point or dtype.is_complex):
        f = float(v)
        if math.isnan(f):
            return 'float("nan")'
        if math.isinf(f):
            return 'float("inf")' if f > 0 else '-float("inf")'
        return repr(f)
    if dtype is None and isinstance(v, float):
        return _lit(v, torch.float32)
    return str(int(v))


def _affine(op: str, a: _Val, b: _Val, alpha) -> tuple | None:
    """The iterator-affine form ``(axis, coef, offset)`` of ``a op
    alpha*b`` for integer values, when one side is affine and the other
    an integer constant; ``None`` otherwise."""
    def const(v):
        return (int(v.const) if v.const is not None and not v.lane
                and float(v.const) == int(v.const) else None)

    ca, cb = const(a), const(b)
    if cb is not None and a.aff is not None:
        ax, m, c = a.aff
        cb *= alpha
        return {"+": (ax, m, c + cb), "-": (ax, m, c - cb),
                "*": (ax, m * cb, c * cb)}.get(op)
    if ca is not None and b.aff is not None:
        ax, m, c = b.aff
        m, c = m * alpha, c * alpha
        return {"+": (ax, m, ca + c), "-": (ax, -m, ca - c),
                "*": (ax, ca * m, ca * c)}.get(op)
    return None


def _roles(ta, tb, name) -> dict:
    """Per tensor node of trace ``ta``, each dim's role: ``"lane"`` (its
    size follows the lane count), ``"v"`` (a value axis) or ``"1"``."""
    na, nb = list(ta.graph.nodes), list(tb.graph.nodes)
    if len(na) != len(nb) or any(
            a.op != b.op or a.target != b.target for a, b in zip(na, nb)):
        raise CompileError(
            f"span kernel: the body of {name!r} traces to different graphs "
            "at different lane counts")
    roles = {}
    for a, b in zip(na, nb):
        va, vb = a.meta.get("val"), b.meta.get("val")
        if not isinstance(va, torch.Tensor):
            continue
        sa, sb = tuple(va.shape), tuple(vb.shape)
        roles[a] = tuple("lane" if x != y else ("v" if x > 1 else "1")
                         for x, y in zip(sa, sb))
    return roles


@dataclasses.dataclass(frozen=True)
class _Shape:
    """What a span's bodies need of the tiling: whether they hold a
    matrix product on ``tl.dot`` (``dot``) or a product of row sums
    (``mv``: a matrix-vector product, a product one position wide, an
    integer product), the output length of the first row-times-matrix
    product on ``tl.dot`` (``vec``: the grid's value axis), and whether a
    value axis is too long for the default tile (``long``)."""

    dot: bool
    vec: int | None
    outer: bool
    long: bool
    mv: bool = False
    products: int = 0       # matrix products on tl.dot, over all stages


def _span_shape(stage_roles, default_block) -> _Shape:
    dot = outer = long = mv = False
    vec, products = None, 0
    for graph, roles in stage_roles:
        for n in graph.nodes:
            r = roles.get(n)
            if r is None or n.op == "placeholder":
                continue
            shape = tuple(n.meta["val"].shape)
            vdims = [s for s, x in zip(shape, r) if x == "v"]
            # a per-lane value holds one value axis (an env array seen
            # whole or transposed holds two, and stays in memory)
            if len(vdims) == 1 and pow2_at_least(
                    vdims[0]) * default_block > _MAX_TILE_ELEMS:
                long = True
            if n.op != "call_function" or n.target not in _PRODUCTS:
                continue
            one_col = not vdims and r.count("lane") == 1
            if n.target is aten.mm.default and r.count("lane") == 2:
                outer = True
                if n.meta["val"].dtype.is_floating_point:
                    dot, products = True, products + 1
                continue
            if n.target is aten.mv.default or one_col \
                    or not n.meta["val"].dtype.is_floating_point:
                # row sums: a matrix-vector product, a product one
                # position wide, an integer product (no tl.dot)
                mv = True
                continue
            dot = True
            products += 1
            if n.target is aten.mm.default and len(vdims) == 1:
                vec = vdims[0] if vec is None else vec
    return _Shape(dot=dot, vec=vec, outer=outer, long=long, mv=mv,
                  products=products)


def _span_tiles(chunks, shape: _Shape):
    """Lane tiles of a span: the default rule (32..1024 lanes) for
    pointwise bodies; tiles of 16-128 lanes an axis where ``tl.dot``
    takes them as a matrix dim; a few lanes where a matrix-vector product
    or a long value axis makes each lane's row wide."""
    if shape.outer:
        return derive_nest_tiles(chunks, max_lanes=_DOT2_LANES * _DOT2_LANES,
                                 min_tile=_DOT_MIN, min_lead=_DOT_MIN,
                                 max_last=_DOT2_LANES)
    if shape.vec is not None:
        return derive_nest_tiles(chunks, max_lanes=_DOT_LANES,
                                 min_tile=_DOT_MIN)
    if shape.dot:
        return derive_nest_tiles(chunks, max_lanes=_DOT_MIN,
                                 min_tile=_DOT_MIN)
    if shape.mv:
        return derive_nest_tiles(chunks, max_lanes=_MV_LANES, min_tile=1)
    if shape.long:
        return derive_nest_tiles(chunks, max_lanes=_LONG_LANES, min_tile=1)
    return derive_nest_tiles(chunks)


class _Gen:
    """Walks the aten graphs of a span's stages in order, emitting one
    kernel body line by line; :meth:`stage` starts each stage."""

    def __init__(self, plans, traces, block: int | None = None):
        plan0 = plans[0]
        self.rank = plan0.rank
        p0 = plan0.chunks_axes[0].num_devices
        #: a rank window's (block, P), or None for every rank; the name of
        #: the global slot of the first nest axis (the local one's where
        #: the two are the same)
        self.window = None if block in (None, p0) else (block, p0)
        self.gslot = ("slot" if self.rank == 1 else "si") \
            if self.window is None else ("gslot" if self.rank == 1 else "gsi")
        self.lines: list = []       # lines, and lists placed before a loop
        self.head: list[str] = []
        self.ind = ""
        self.n = 0
        self.flops = 0
        self.dot_flops = 0
        self.full_scopes: dict[int, _Scope] = {}
        self.ptrs: dict[tuple, str] = {}
        self.inputs: list = []
        # key -> (register tile or None, write bases, where its rows were
        # stored when tile by tile: (pointer, row base, k, type))
        self.fwd_vals: dict[str, tuple] = {}
        self.fwd_reads: list = []
        self.iter_vecs: dict[tuple, str] = {}
        self.libdevice = False      # the body calls CUDA's libdevice
        self.combiners: dict = {}   # scan combine functions the body uses
        self.barriers: set = set()  # stages that re-load stored rows
        chs = plan0.chunks_axes
        chunks = tuple(ch.chunk for ch in chs)
        self.stage_roles = [_roles(ta, tb, plan.name)
                            for plan, (ta, tb) in zip(plans, traces)]
        default = math.prod(t.tile for t in derive_nest_tiles(chunks))
        self.shape = _span_shape([
            (ta.graph, r) for (ta, _), r in zip(traces, self.stage_roles)],
            default)
        self.tiles = _span_tiles(chunks, self.shape)
        self.block = math.prod(t.tile for t in self.tiles)
        # the grid's value axis: the output of a row-times-matrix product,
        # split into tiles of the product's column width
        self.grid_scope, self.value_tiles = None, 1
        if self.shape.vec is not None and not self.fits(self.shape.vec):
            n = self.shape.vec
            bt = min(max(pow2_at_least(n), _DOT_MIN), max(
                _DOT_MIN, _DOT_TILE_SCALE * _MAX_TILE_ELEMS // self.block))
            self.value_tiles = -(-n // bt)
            self.grid_scope = _Scope(n, "gr", "gm", bt, start=f"(vt * {bt})")
            self.head.append(f"    gr = vt * {bt} + tl.arange(0, {bt})"
                             "[None, :]")
            self.head.append(f"    gm = gr < {n}")
        # 64-bit offsets once an input buffer or a dense output could pass
        # 2^31 elements; 32-bit below
        sizes = [math.prod(plan.context.vars[k].shape)
                 for plan in plans for k in plan.context.env_keys]
        sizes += [math.prod(_out_shape(plan, k))
                  for plan in plans for k in plan.written_keys]
        self.wide = max(sizes, default=0) >= _WIDE_ELEMS
        self.loops0 = plan0.nest.axes

    def stage(self, si, plan, trace_a, forwarded) -> None:
        """Begin stage ``si``: its graph's values, and the keys whose
        reads come from an earlier span stage's register tile."""
        self.si, self.plan = si, plan
        self.forwarded = frozenset(forwarded)
        self.vals = {}
        self.roles = self.stage_roles[si]
        self.constants = ctx_mod.graph_constants(trace_a.graph)
        self._line(f"# stage {si}: {plan.name}")
        for d, (it, name) in enumerate(zip(trace_a.iter_nodes, ("i0", "j0"))):
            loop, loop0 = plan.nest.axes[d], self.loops0[d]
            if (loop.start, loop.step) != (loop0.start, loop0.step):
                it_name = "it" if self.rank == 1 else ("iti", "itj")[d]
                name = self.emit(
                    f"({loop.start} + {loop.step} * tl.minimum({it_name}, "
                    f"{loop.trip_count - 1})).to(tl.int32)",
                    torch.int32, True, None).expr
            self.vals[it] = _Val(name, torch.int32, lane=True, aff=(d, 1, 0))
        for key, node in trace_a.env_nodes.items():
            info = plan.context.vars[key]
            self.vals[node] = _Val(mem=_Mem(key, tuple(info.shape), {},
                                            list(range(len(info.shape)))))

    def _form(self, node):
        roles = self.roles[node]
        shape = tuple(node.meta["val"].shape)
        vdims = [shape[d] for d, r in enumerate(roles) if r == "v"]
        if len(vdims) > 1:
            raise CompileError(
                f"span kernel: {node.target} in {self.plan.name!r} makes a "
                f"per-lane value of shape {tuple(vdims)}; the template holds "
                "at most one value axis per lane")
        return "lane" in roles, (vdims[0] if vdims else None)

    # -- emission helpers ---------------------------------------------------

    def _line(self, text: str) -> None:
        self.lines.append(f"    {self.ind}{text}")

    def emit(self, expr: str, dtype, lane: bool, k) -> _Val:
        name = f"v{self.n}"
        self.n += 1
        self._line(f"{name} = {expr}")
        return _Val(name, dtype, lane=lane, k=k)

    def vtile(self, k: int) -> int:
        """Width of one tile of a value axis of length k: the padded axis
        if it fits the register budget, else the budget (a power of two
        of at least 16, as ``tl.dot`` wants)."""
        kp = pow2_at_least(k)
        if self.shape.dot:
            kp = max(kp, _DOT_MIN)
        return min(kp, max(_DOT_MIN, _MAX_TILE_ELEMS // self.block))

    def fits(self, k: int) -> bool:
        kp = max(pow2_at_least(k), _DOT_MIN if self.shape.dot else 1)
        return self.vtile(k) >= kp

    def full_scope(self, k: int) -> _Scope:
        """The one tile of a value axis that fits: the whole axis."""
        if k not in self.full_scopes:
            if not self.fits(k):
                raise CompileError(
                    f"span kernel: a per-lane value axis of {k} elements in "
                    f"{self.plan.name!r} is needed whole here, and does not "
                    "fit one register tile")
            kp = self.vtile(k)
            r, m = f"kr{k}", f"km{k}"
            self.head.append(f"    {r} = tl.arange(0, {kp})[None, :]")
            self.head.append(f"    {m} = {r} < {k}")
            self.full_scopes[k] = _Scope(k, r, m, kp, start="0", seq=True)
        return self.full_scopes[k]

    @contextlib.contextmanager
    def tiles_of(self, k: int, bt: int | None = None, stages: int = 0):
        """A loop over the tiles of a value axis of length k; yields each
        tile's scope (values emitted in it stay inside the loop).  Given
        ``stages``, Triton pipelines the loop's loads that deep, whether or
        not they feed a ``tl.dot``."""
        bt = bt or self.vtile(k)
        n = self.n
        self.n += 1
        rng = (f"tl.range(0, {k}, {bt}, num_stages={stages})" if stages
               else f"range(0, {k}, {bt})")
        # lines a value emitted in the loop puts before it (a scan's carry)
        pre: list[str] = []
        self.lines.append(pre)
        pre_ind = f"    {self.ind}"
        self._line(f"for t{n} in {rng}:")
        self.ind += "    "
        self._line(f"r{n} = t{n} + tl.arange(0, {bt})[None, :]")
        self._line(f"m{n} = r{n} < {k}")
        try:
            yield _Scope(k, f"r{n}", f"m{n}", bt, start=f"t{n}", seq=True,
                         pre=(pre, pre_ind))
        finally:
            self.ind = self.ind[:-4]

    def tile(self, v: _Val, scope: _Scope | None) -> str:
        """``v``'s expression in ``scope`` (lane scalars: everywhere)."""
        if v.expr is not None:
            if v.scope is not None and v.scope is not scope:
                if v.alt is not None:       # emitted again in this tiling
                    return self.tile(v.alt, scope)
                raise CompileError(
                    f"span kernel: a register tile of a value axis of {v.k} "
                    f"elements in {self.plan.name!r} is read in another "
                    "tiling of that axis")
            return v.expr
        if v.lazy is None or scope is None:
            raise CompileError(
                f"span kernel: a per-lane value of {v.k} elements in "
                f"{self.plan.name!r} is read outside any tile of its axis")
        # keyed by the emitter itself (held, so never a reused id)
        if v.lazy not in scope.cache:
            scope.cache[v.lazy] = v.lazy(scope)
        return scope.cache[v.lazy]

    def cast(self, v: _Val, dtype, scope: _Scope | None = None) -> str:
        if v.const is not None:
            return _lit(v.const, dtype)
        e = self.tile(v, scope)
        if v.dtype == dtype:
            return e
        return f"{e}.to({_TL[dtype]})"

    def pointwise(self, fmt, args, od, lane, k, flops=1) -> _Val:
        """An elementwise op over ``args`` (``(value, type)`` pairs, each
        cast to its type): emitted now for lane scalars, per tile where
        consumed for a value with a value axis."""
        self.flops += flops * (k or 1)
        if k is None:
            return self.emit(fmt(*[self.cast(v, dt) for v, dt in args]), od,
                             lane, None)
        # operands computed by a K-loop first: the loop then runs before
        # the others' tiles are loaded, which would stay live across it
        order = sorted(range(len(args)), key=lambda i: not args[i][0].loop)

        def emit_in(scope):
            es = {i: self.cast(*args[i], scope) for i in order}
            return self.emit(fmt(*[es[i] for i in range(len(args))]), od,
                             lane, k).expr
        return _Val(dtype=od, lane=lane, k=k, lazy=emit_in,
                    loop=any(v.loop for v, _ in args))

    def ptr(self, kind: str, key: str) -> str:
        tag = (self.si, key, kind)
        if tag not in self.ptrs:
            self.ptrs[tag] = f"p{self.si}_{len(self.inputs)}"
            self.inputs.append((kind, self.si, key))
        return self.ptrs[tag]

    def value(self, a) -> _Val:
        if isinstance(a, torch.fx.Node):
            v = self.vals[a]
            if v.mem is not None:
                v = self.load(v.mem, [])
                self.vals[a] = v
            return v
        if isinstance(a, (bool, int, float)):
            return _Val(const=a)
        raise CompileError(
            f"span kernel: argument {a!r} in {self.plan.name!r} is not a "
            "tensor or number")

    # -- loads --------------------------------------------------------------

    def _index_expr(self, v: _Val, size: int, off: str | None,
                    width: int | None) -> str:
        """Index into one buffer axis: rows of a slab window (clamped into
        the window) or positions in a replicated array (negative positions
        wrap, then clamp into bounds — the reference's index semantics)."""
        if v.k is not None:
            raise CompileError(
                f"span kernel: gather with per-lane index vectors in "
                f"{self.plan.name!r} is not supported")
        if not v.lane and v.const is not None:
            e = int(v.const)
            if off is None:
                e = min(max(e + size if e < 0 else e, 0), size - 1)
                return str(e)
        e = self.cast(v, v.dtype or torch.int32) if v.const is None \
            else str(int(v.const))
        if off is not None:
            return self.emit(
                f"tl.minimum(tl.maximum({e} - ({off}), 0), {width - 1})",
                torch.int32, v.lane, None).expr
        return self.emit(
            f"tl.minimum(tl.maximum(tl.where({e} < 0, {e} + {size}, {e}), "
            f"0), {size - 1})", torch.int32, v.lane, None).expr

    def _address(self, mem: _Mem, parts: dict,
                 kind: str | None = None) -> tuple[str, str]:
        """Pointer and element offset of ``env[mem.key]`` at ``parts[d]``
        on each dim not fixed: an index value, or an expression (a token
        ``@R@``/``@K@`` for a whole axis, filled in per tile).  ``kind``
        names another form of the array the kernel is handed (``"replT"``:
        its transpose, of shape ``mem.shape``)."""
        plan, key = self.plan, mem.key
        dec = plan.vars[key]
        shape = mem.shape
        sharded = dec.in_strategy in ("shard", "shard_halo")
        n_sh = (1 if self.rank == 1 else dec.shard_ndim) if sharded else 0
        chs = plan.chunks_axes
        offs, widths = [], []
        for d in range(n_sh):
            halo = dec.window(d)
            slot = self.gslot if d == 0 else "sj"
            offs.append(f"{slot} * {chs[d].chunk} + {halo[0]}")
            widths.append(window_extent(chs[d].chunk, halo))
        exprs = []
        for d, size in enumerate(shape):
            if d in mem.fixed:
                exprs.append(str(mem.fixed[d]))
            elif mem.starts.get(d, (0,))[0]:
                exprs.append(f"({mem.starts[d][0]} + {parts[d]})")
            elif isinstance(parts[d], str):
                exprs.append(parts[d])
            else:
                exprs.append(self._index_expr(
                    parts[d], size, offs[d] if d < n_sh else None,
                    widths[d] if d < n_sh else None))
        if self.wide:       # offsets past 2^31 elements: 64-bit indices
            exprs = [e if e.lstrip("-").isdigit() else f"({e}).to(tl.int64)"
                     for e in exprs]
        off = self._offset(exprs, shape, n_sh, widths)
        return self.ptr(kind or ("win" if sharded else "repl"), key), off

    def load(self, mem: _Mem, indices: list) -> _Val:
        v = self._load(mem, indices)
        if mem.dtype is None or mem.dtype == v.dtype:
            return v
        return self.pointwise(lambda e: e, [(v, mem.dtype)], mem.dtype,
                              v.lane, v.k, 0)

    def _load(self, mem: _Mem, indices: list) -> _Val:
        if mem.starts:
            raise CompileError(
                f"span kernel: a slice of env[{mem.key!r}] in "
                f"{self.plan.name!r} is read outside a product; the template "
                "reads a slice only as a product's operand")
        if mem.key in self.forwarded:
            return self._forwarded(mem, indices)
        plan, key = self.plan, mem.key
        info = plan.context.vars[key]
        idx_by_dim = {d: (indices[p] if p < len(indices) else None)
                      for p, d in enumerate(mem.remaining)}
        parts, lane, whole, index, gather = {}, False, [], {}, {}
        for d, size in enumerate(mem.shape):
            if d in mem.fixed:
                continue
            ix = idx_by_dim.get(d)
            if ix is None:                       # a whole axis
                if size == 1:
                    parts[d] = "0"
                else:
                    whole.append(d)
                    parts[d] = "@R@"
                continue
            if not isinstance(ix, torch.fx.Node):
                raise CompileError(
                    f"span kernel: index {ix!r} of env[{key!r}] is not a "
                    "tensor")
            v = self.value(ix)
            if v.dtype is None or v.dtype.is_floating_point \
                    or v.dtype == torch.bool:
                raise CompileError(
                    f"span kernel: env[{key!r}] indexed by a {v.dtype} value "
                    f"in {plan.name!r}")
            lane |= v.lane
            if v.k is not None:         # a per-lane index vector: a gather
                gather[d] = v
                parts[d] = f"@G{d}@"
            else:
                parts[d] = index[d] = v
        if len(whole) > 1:
            raise CompileError(
                f"span kernel: env[{key!r}] read with two whole axes in "
                f"{plan.name!r} outside a matrix product; the template holds "
                "one value axis per lane")
        if gather:
            return self._gather(mem, parts, gather, whole, lane)
        p, off = self._address(mem, parts)
        if not whole:
            return self.emit(f"tl.load({p} + {off})", info.dtype, lane, None)
        k = mem.shape[whole[0]]

        def emit_in(scope):
            o = off.replace("@R@", scope.r)
            return self.emit(f"tl.load({p} + {o}, mask={scope.m}, other=0)",
                             info.dtype, lane, k).expr
        return _Val(dtype=info.dtype, lane=lane, k=k, lazy=emit_in,
                    src=(mem, index, whole[0]))

    def _gather(self, mem: _Mem, parts: dict, gather: dict, whole: list,
                lane: bool) -> _Val:
        """``x[idx]`` for a per-lane index vector ``idx`` into a replicated
        array: a load at computed offsets, per tile of the index's value
        axis.  An index wraps once if negative, then clamps into bounds,
        as the reference's indexing does (and the plain path's
        ``ClampedArray``)."""
        plan, key = self.plan, mem.key
        where = (f"span kernel: env[{key!r}] gathered through a per-lane "
                 f"index vector in {plan.name!r}")
        if plan.vars[key].in_strategy in ("shard", "shard_halo"):
            raise CompileError(f"{where} is a chunk-sharded window; the "
                               "template gathers from replicated arrays")
        if whole or len({v.k for v in gather.values()}) > 1:
            raise CompileError(f"{where} makes more than one value axis; "
                               "the template holds one per lane")
        k = next(iter(gather.values())).k
        p, off = self._address(mem, parts)
        dt = plan.context.vars[key].dtype

        def emit_in(scope):
            o = off
            for d, v in gather.items():
                e = self.tile(v, scope)
                size = mem.shape[d]
                ix = self.emit(
                    f"tl.minimum(tl.maximum(tl.where({e} < 0, {e} + {size}, "
                    f"{e}), 0), {size - 1})", v.dtype, v.lane, k).expr
                o = o.replace(f"@G{d}@", ix)
            return self.emit(f"tl.load({p} + {o}, mask={scope.m}, other=0)",
                             dt, lane, k).expr
        return _Val(dtype=dt, lane=lane, k=k, lazy=emit_in,
                    loop=any(v.loop for v in gather.values()))

    def _reload(self, out_ptr: str, base: str, k: int, dt) -> _Val:
        """The lane's own row of a key an earlier span stage stored tile by
        tile, loaded back from where that stage stored it, after a
        block-wide barrier: the same program wrote exactly those
        addresses, so nothing outside the program is waited on."""
        if self.si not in self.barriers:
            self.barriers.add(self.si)
            self._line("tl.debug_barrier()")

        def emit_in(scope):
            return self.emit(f"tl.load({out_ptr} + {base} * {k} + {scope.r}, "
                             f"mask=lmask & {scope.m}, other=0)", dt, True,
                             k).expr
        return _Val(dtype=dt, lane=True, k=k, lazy=emit_in)

    def _forwarded(self, mem: _Mem, indices: list) -> _Val:
        """A read of a key an earlier span stage wrote for the same
        lanes: the register tile that stage stored, never a reload.  Only
        a read of the lane's OWN row is served so: on every sharded axis
        the index must be exactly ``k + base`` for the lane's iteration
        number ``k``, where ``base`` is where the producer wrote lane
        ``k`` (its write base, which a resident feed's window base
        equals: row offset 0 after ``halo_base``).  Anything else raises
        at compile time rather than read another lane's register."""
        plan, key = self.plan, mem.key
        dec = plan.vars[key]
        where = (f"span kernel: stage {plan.name!r} reads {key!r}, which an "
                 "earlier stage of its span hands over on chip")
        n_sh = 1 if self.rank == 1 else dec.shard_ndim
        if dec.in_strategy not in ("shard", "shard_halo") or n_sh != self.rank:
            raise CompileError(f"{where}, but not as a lane-aligned "
                               "chunk-sharded read")
        idx_by_dim = {d: (indices[p] if p < len(indices) else None)
                      for p, d in enumerate(mem.remaining)}
        fv, bases, stored = self.fwd_vals[key]
        if fv is None and stored is None:
            raise CompileError(f"{where}, stored tile by tile by the "
                               "programs of the grid's value axis: no one "
                               "program holds the row")
        for d in range(n_sh):
            ix = idx_by_dim.get(d)
            v = self.value(ix) if isinstance(ix, torch.fx.Node) else None
            loop = plan.nest.axes[d]
            ok = (d not in mem.fixed and v is not None and v.aff is not None
                  and v.k is None and v.aff[0] == d
                  and v.aff[1] * loop.step == 1
                  and v.aff[1] * loop.start + v.aff[2] == bases[d]
                  == dec.window(d)[0])
            if not ok:
                raise CompileError(
                    f"{where}: its axis-{d} index is not the lane's own row "
                    "(offset 0 after the window base), so the tile cannot "
                    "be forwarded")
        self.fwd_reads.append((self.si, key))
        if fv is None:                      # stored tile by tile: re-load
            fv = self._reload(*stored)
        rest = [d for d in range(n_sh, len(mem.shape)) if mem.shape[d] != 1]
        if not rest:
            return fv
        if len(rest) > 1 or fv.k != mem.shape[rest[0]]:
            raise CompileError(f"{where} with {len(rest)} value axes; the "
                               "template forwards one")
        d = rest[0]
        ix = idx_by_dim.get(d)
        if d in mem.fixed:
            pos = mem.fixed[d]
        elif ix is None:
            return fv                       # the whole value axis
        else:
            c = self.value(ix) if isinstance(ix, torch.fx.Node) else None
            if c is None or c.const is None or c.lane:
                raise CompileError(f"{where} at a per-lane value index")
            pos = int(c.const)
        pos = pos + fv.k if pos < 0 else pos
        if stored is not None:
            return _Val(self.tile(fv, _Scope(fv.k, str(pos), "True", 1)),
                        fv.dtype, lane=True)
        sc = self.full_scope(fv.k)
        return self.emit(f"tl.sum(tl.where({sc.r} == {pos}, {fv.expr}, 0), "
                         "axis=1)[:, None]", fv.dtype, True, None)

    def _offset(self, exprs, shape, n_sh, widths) -> str:
        def lin(es, dims):
            strides = [math.prod(dims[i + 1:]) for i in range(len(dims))]
            terms = [f"({e}) * {s}" for e, s in zip(es, strides) if e != "0"]
            return " + ".join(terms) or "0"

        if n_sh == 0:
            return f"({lin(exprs, shape)})"
        chs = self.plan.chunks_axes
        if self.rank == 1:
            rest = math.prod(shape[1:])
            return (f"((slot * {widths[0]} + {exprs[0]}) * {rest} + "
                    f"{lin(exprs[1:], shape[1:])})")
        if n_sh == 1:
            rest = math.prod(shape[1:])
            return (f"((si * {widths[0]} + {exprs[0]}) * {rest} + "
                    f"{lin(exprs[1:], shape[1:])})")
        sj = chs[1].local_chunks * chs[1].num_devices
        rest = math.prod(shape[2:])
        return (f"(((si * {widths[0]} + {exprs[0]}) * {sj * widths[1]} + "
                f"sj * {widths[1]} + {exprs[1]}) * {rest} + "
                f"{lin(exprs[2:], shape[2:])})")

    # -- ops ----------------------------------------------------------------

    _BIN = {
        aten.add.Tensor: "+", aten.add.Scalar: "+",
        aten.sub.Tensor: "-", aten.sub.Scalar: "-",
        aten.mul.Tensor: "*", aten.mul.Scalar: "*",
        aten.div.Tensor: "/", aten.div.Scalar: "/",
    }
    _CMP = {getattr(getattr(aten, name), ov): sym
            for name, sym in (("lt", "<"), ("le", "<="), ("gt", ">"),
                              ("ge", ">="), ("eq", "=="), ("ne", "!="))
            for ov in ("Tensor", "Scalar")}
    #: Pointwise math in float32 (float64 kept), the result cast back:
    #: Triton's own functions, and CUDA's libdevice where Triton has none.
    _MATH = {aten.exp.default: "tl.exp", aten.log.default: "tl.log",
             aten.sqrt.default: "tl.sqrt", aten.sin.default: "tl.sin",
             aten.cos.default: "tl.cos", aten.rsqrt.default: "tl.rsqrt",
             aten.erf.default: "tl.erf", aten.sigmoid.default: "tl.sigmoid",
             aten.tan.default: "libdevice.tan",
             aten.tanh.default: "libdevice.tanh",
             aten.log1p.default: "libdevice.log1p",
             aten.expm1.default: "libdevice.expm1"}
    #: Rounding: the identity on integers (``round`` is half to even).
    _ROUND = {aten.floor.default: "tl.floor", aten.ceil.default: "tl.ceil",
              aten.round.default: "libdevice.rint"}
    _CLAMP = {aten.clamp.default: (1, 2), aten.clamp.Tensor: (1, 2),
              aten.clamp_min.default: (1, None),
              aten.clamp_min.Tensor: (1, None),
              aten.clamp_max.default: (None, 1),
              aten.clamp_max.Tensor: (None, 1)}
    _POW = (aten.pow.Tensor_Scalar, aten.pow.Tensor_Tensor, aten.pow.Scalar)
    _SORT = (aten.sort.default, aten.sort.stable)
    _CUM_EXTREME = {aten.cummax.default: "max", aten.cummin.default: "min"}
    _REDUCE = {aten.sum.dim_IntList: "sum", aten.sum.default: "sum",
               aten.mean.dim: "mean", aten.mean.default: "mean",
               aten.amax.default: "max", aten.amin.default: "min"}

    def _result_type(self, vals) -> torch.dtype:
        probes = []
        for v in vals:
            if v.const is not None and v.dtype is None:
                probes.append(v.const)
            elif v.lane or v.k is not None:
                probes.append(torch.zeros(1, dtype=v.dtype))
            else:
                probes.append(torch.zeros((), dtype=v.dtype))
        return torch.result_type(*probes) if len(probes) == 2 else \
            probes[0].dtype

    def node(self, n) -> None:
        if n.op == "get_attr":
            c = self.constants[n.target]
            if c.ndim != 0:
                raise CompileError(
                    f"span kernel: tensor constant of shape {tuple(c.shape)} "
                    f"in the body of {self.plan.name!r}")
            self.vals[n] = _Val(const=c.item(), dtype=c.dtype)
            return
        if n.op != "call_function":
            return
        t, args = n.target, n.args
        if t is aten.select.int:
            src = self.vals[args[0]]
            if src.mem is not None:
                m = src.mem
                d = m.remaining[args[1]]
                idx = args[2] + m.extent(d) if args[2] < 0 else args[2]
                starts = dict(m.starts)
                idx += starts.pop(d, (0, 0))[0]
                self.vals[n] = _Val(mem=dataclasses.replace(
                    m, fixed={**m.fixed, d: idx}, starts=starts,
                    remaining=m.remaining[:args[1]] + m.remaining[args[1] + 1:]))
            else:
                self.vals[n] = self._select(n, self.value(args[0]))
            return
        if t in _MEM_VIEWS and self.vals[args[0]].mem is not None:
            # a transposed env array stays unloaded: a product reads it
            m = self.vals[args[0]].mem
            rem = list(m.remaining)
            if t is aten.permute.default:
                rem = [rem[p] for p in args[1]]
            elif t is aten.transpose.int:
                a, b = (x % len(rem) for x in args[1:3])
                rem[a], rem[b] = rem[b], rem[a]
            else:
                rem = rem[::-1]
            self.vals[n] = _Val(mem=dataclasses.replace(m, remaining=rem))
            return
        src = self.vals.get(args[0]) if args and isinstance(
            args[0], torch.fx.Node) else None
        m = src.mem if isinstance(src, _Val) else None
        if t is aten.slice.Tensor and m is not None:
            # a step-1 slice of an env array: a product reads the sub-range
            dim, lo, hi, step = (list(args[1:]) + [0, None, None, 1][
                len(args) - 1:])
            if step != 1:
                raise CompileError(
                    f"span kernel: a slice of env[{m.key!r}] with step "
                    f"{step} in {self.plan.name!r}")
            d = m.remaining[dim]
            first, length = m.starts.get(d, (0, m.shape[d]))
            r = range(length)[lo:hi]
            self.vals[n] = _Val(mem=dataclasses.replace(
                m, starts={**m.starts, d: (first + r.start, len(r))}))
            return
        if t is aten._to_copy.default and m is not None \
                and len(m.remaining) == 2:
            # a replicated matrix cast for a product (the body's twin of a
            # mixed jnp.dot): it stays unloaded, the product reads it cast
            self.vals[n] = _Val(mem=dataclasses.replace(
                m, dtype=n.meta["val"].dtype))
            return
        if t is aten.index.Tensor:
            src = self.vals[args[0]]
            if src.mem is None:
                raise CompileError(
                    f"span kernel: aten.index.Tensor on a computed value in "
                    f"{self.plan.name!r} is not supported")
            self.vals[n] = self.load(src.mem, list(args[1]))
            return
        if t in _PRODUCTS:
            self.vals[n] = self._product(n)
            return
        if t is aten.roll.default:
            self.vals[n] = self._roll(n)
            return
        # an op of two results: each emitted when a getitem asks for it
        if t in self._SORT:
            self.vals[n] = [lambda: self._sort(n), lambda: self._argsort(n)]
            return
        if t in self._CUM_EXTREME:
            self.vals[n] = [
                lambda: self._cumsum(n, self.value(args[0]),
                                     n.meta["val"][0].dtype,
                                     self._CUM_EXTREME[t]),
                lambda: self._refuse_indices(t)]
            return
        if t is operator.getitem and isinstance(self.vals[args[0]], list):
            pair = self.vals[args[0]]
            if callable(pair[args[1]]):
                pair[args[1]] = pair[args[1]]()
            self.vals[n] = pair[args[1]]
            return
        od = n.meta["val"].dtype
        lane, k = self._form(n)
        if t in self._BIN:
            a, b = self.value(args[0]), self.value(args[1])
            alpha = n.kwargs.get("alpha", 1)
            op = self._BIN[t]
            sa = f" * {_lit(alpha, od)}" if alpha != 1 else ""
            v = self.pointwise(lambda x, y: f"({x} {op} ({y}{sa}))"
                               if sa else f"({x} {op} {y})",
                               [(a, od), (b, od)], od, lane, k)
            if not (od.is_floating_point or od == torch.bool):
                v.aff = _affine(op, a, b, alpha)
            self.vals[n] = v
        elif t in self._CMP:
            a, b = self.value(args[0]), self.value(args[1])
            ct = self._result_type([a, b])
            op = self._CMP[t]
            self.vals[n] = self.pointwise(lambda x, y: f"({x} {op} {y})",
                                          [(a, ct), (b, ct)], od, lane, k)
        elif t in (aten.maximum.default, aten.minimum.default):
            a, b = self.value(args[0]), self.value(args[1])
            fn = "tl.maximum" if t is aten.maximum.default else "tl.minimum"
            nan = _nan_arg(od)
            self.vals[n] = self.pointwise(
                lambda x, y: f"{fn}({x}, {y}{nan})",
                [(a, od), (b, od)], od, lane, k)
        elif t in (aten.where.self, aten.where.ScalarSelf,
                   aten.where.ScalarOther, aten.where.Scalar):
            c, a, b = (self.value(x) for x in args[:3])
            self.vals[n] = self.pointwise(
                lambda x, y, z: f"tl.where({x}, {y}, {z})",
                [(c, torch.bool), (a, od), (b, od)], od, lane, k)
        elif t in (aten.remainder.Scalar, aten.remainder.Tensor) \
                and not od.is_floating_point:
            # Python's modulo (sign of the divisor) from C's remainder
            a, b = self.value(args[0]), self.value(args[1])
            self.vals[n] = self.pointwise(
                lambda x, y: (f"tl.where((({x} % {y}) != 0) & ((({x} % {y}) "
                              f"< 0) != ({y} < 0)), ({x} % {y}) + {y}, "
                              f"({x} % {y}))"),
                [(a, od), (b, od)], od, lane, k, 3)
        elif t is aten.neg.default:
            x = self.value(args[0])
            v = self.pointwise(lambda e: f"(-{e})", [(x, od)], od, lane, k)
            if x.aff is not None:
                v.aff = (x.aff[0], -x.aff[1], -x.aff[2])
            self.vals[n] = v
        elif t is aten.abs.default:
            self.vals[n] = self.pointwise(lambda e: f"tl.abs({e})",
                                          [(self.value(args[0]), od)], od,
                                          lane, k)
        elif t is aten.reciprocal.default:
            self.vals[n] = self.pointwise(lambda e: f"(1.0 / {e})",
                                          [(self.value(args[0]), od)], od,
                                          lane, k)
        elif t in self._MATH or (t in self._ROUND
                                 and od.is_floating_point):
            fn = self._MATH.get(t) or self._ROUND[t]
            self.libdevice |= fn.startswith("libdevice.")
            wd = od if od in (torch.float32, torch.float64) else torch.float32
            tail = "" if wd == od else f".to({_TL[od]})"
            self.vals[n] = self.pointwise(lambda e: f"{fn}({e}){tail}",
                                          [(self.value(args[0]), wd)], od,
                                          lane, k)
        elif t in self._ROUND:          # an integer rounds to itself
            self.vals[n] = self.pointwise(lambda e: e,
                                          [(self.value(args[0]), od)], od,
                                          lane, k, 0)
        elif t in self._POW:
            self.vals[n] = self._pow(n, od, lane, k)
        elif t is aten.sign.default:
            one, zero = ("1.0", "0.0") if od.is_floating_point else ("1", "0")
            x = self.value(args[0])
            # zero (and NaN) keep their own value, as torch.sign does
            keep = "{e}" if od.is_floating_point else zero
            self.vals[n] = self.pointwise(
                lambda e: (f"tl.where({e} > 0, {one}, tl.where({e} < 0, "
                           f"-{one}, {keep.format(e=e)}))"),
                [(x, od)], od, lane, k, 2)
        elif t in self._CLAMP:
            lo_at, hi_at = self._CLAMP[t]
            bounds = [self.value(args[i]) if i is not None and i < len(args)
                      and args[i] is not None else None
                      for i in (lo_at, hi_at)]
            x = self.value(args[0])
            lo, hi = bounds
            vals = [(x, od)] + [(b, od) for b in bounds if b is not None]
            nan = _nan_arg(od)

            def clamp(e, *bs, lo=lo, hi=hi):
                bs = list(bs)
                if lo is not None:
                    e = f"tl.maximum({e}, {bs.pop(0)}{nan})"
                if hi is not None:
                    e = f"tl.minimum({e}, {bs.pop(0)}{nan})"
                return e
            self.vals[n] = self.pointwise(clamp, vals, od, lane, k, 2)
        elif t is aten._to_copy.default:
            x = self.value(args[0])
            if x.const is not None and not x.lane:
                v = x.const
                if od == torch.bool:
                    v = bool(v)
                elif not (od.is_floating_point or od.is_complex):
                    v = int(v)
                else:
                    v = float(v)
                self.vals[n] = _Val(const=v, dtype=od, lane=lane, k=k)
            else:
                v = self.pointwise(lambda e: e, [(x, od)], od, lane, k, 0)
                if not (od.is_floating_point or od == torch.bool):
                    v.aff = x.aff
                self.vals[n] = v
        elif t in _VIEWS:
            x = self.value(args[0])
            if x.k is not None and k != x.k:
                raise CompileError(
                    f"span kernel: {t} in {self.plan.name!r} reshapes a "
                    f"per-lane value axis of {x.k} elements")
            self.vals[n] = dataclasses.replace(x, lane=lane or x.lane, k=k)
        elif t in (aten.full.default, aten.scalar_tensor.default):
            fill = args[1] if t is aten.full.default else args[0]
            if k is None:
                self.vals[n] = _Val(const=fill, dtype=od, lane=lane)
            else:
                def emit_in(scope, fill=fill, od=od, k=k):
                    return self.emit(f"tl.full([1, {scope.bt}], "
                                     f"{_lit(fill, od)}, {_TL[od]})",
                                     od, False, k).expr
                self.vals[n] = _Val(dtype=od, lane=False, k=k, lazy=emit_in)
        elif t in self._REDUCE:
            self.vals[n] = self._reduce(n, self._REDUCE[t],
                                        self.value(args[0]), od, lane)
        elif t is aten.cumsum.default:
            self.vals[n] = self._cumsum(n, self.value(args[0]), od)
        elif t is aten.cumprod.default:
            self.vals[n] = self._cumsum(n, self.value(args[0]), od, "prod")
        elif t is aten.logcumsumexp.default:
            self.vals[n] = self._cumsum(n, self.value(args[0]), od, "lse")
        else:
            raise CompileError(
                f"span kernel: aten op {t} in the body of {self.plan.name!r} "
                "is not supported by the Triton template (supported: "
                "pointwise arithmetic and math, comparisons, where, clamp, "
                "affine env reads and gathers from replicated arrays, "
                "sum/mean/amax/amin, cumsum, cumprod, logcumsumexp, the "
                "values of cummax/cummin and roll along a value axis, the "
                "values and indices of a sort of a row that fits one "
                "register tile, mm/mv of a per-lane row and a replicated "
                "array)")

    def _refuse_indices(self, t):
        raise CompileError(
            f"span kernel: {t}'s indices in {self.plan.name!r} are not "
            "supported by the Triton template (its values are; the "
            "reference has no jnp twin of the indices)")

    def _pow(self, n, od, lane, k) -> _Val:
        """``pow`` with a tensor or a scalar exponent (or base): a square
        is one multiply, anything else CUDA's ``pow`` in float32; of
        integers, :meth:`_int_pow`."""
        t, args = n.target, n.args
        if not od.is_floating_point:
            return self._int_pow(n, od, lane, k)
        wd = od if od == torch.float64 else torch.float32
        tail = "" if wd == od else f".to({_TL[od]})"
        if t is aten.pow.Tensor_Scalar and args[1] == 2:
            return self.pointwise(lambda e: f"({e} * {e})",
                                  [(self.value(args[0]), od)], od, lane, k)
        self.libdevice = True

        def operand(a):
            if isinstance(a, torch.fx.Node):
                return self.value(a), wd
            # a scalar operand as a [1, 1] tile: libdevice takes tensors
            return _Val(const=a, dtype=wd), wd
        vals = [operand(a) for a in args[:2]]
        full = [isinstance(a, torch.fx.Node) for a in args[:2]]

        def fmt(a, b):
            a, b = (e if f else f"tl.full([1, 1], {e}, {_TL[wd]})"
                    for e, f in zip((a, b), full))
            return f"libdevice.pow({a}, {b}){tail}"
        return self.pointwise(fmt, vals, od, lane, k, 4)

    def _int_pow(self, n, od, lane, k) -> _Val:
        """An integer ``pow`` by a constant non-negative exponent: repeated
        squaring in the integer type, so it wraps as int32 products do in
        torch and ``jnp``.  A tensor exponent, or an integer base raised
        to a tensor, raises naming itself."""
        t, args = n.target, n.args
        e = args[1] if t is aten.pow.Tensor_Scalar else None
        if isinstance(e, bool) or not isinstance(e, int) or e < 0:
            what = ("a tensor exponent" if e is None
                    else f"the exponent {e!r}")
            raise CompileError(
                f"span kernel: {t} of integers with {what} in "
                f"{self.plan.name!r} is not supported by the Triton template "
                "(an integer pow by a constant non-negative exponent is)")

        def squarings(x):
            terms, p = [], e
            while p:
                if p & 1:
                    terms.append(x)
                p >>= 1
                if p:
                    x = f"({x} * {x})"
            return f"({' * '.join(terms)})" if terms else f"({x} * 0 + 1)"
        return self.pointwise(squarings, [(self.value(args[0]), od)], od,
                              lane, k, max(1, 2 * e.bit_length() - 1))

    def _sort_row(self, n):
        """``(x, descending, scope)`` of ``sort(x)`` along a per-lane value
        axis that fits one register tile (the scope holds it whole);
        ``(x, descending, None)`` for a sort of one element.  A row longer
        than one register tile, or a sort across lanes, raises."""
        args = n.args
        roles = self.roles[args[0]]
        dim = args[1] if len(args) > 1 else n.kwargs.get("dim", -1)
        desc = bool(args[2] if len(args) > 2
                    else n.kwargs.get("descending", False))
        dim = dim % len(roles) if roles else 0
        where = f"span kernel: aten.sort in {self.plan.name!r}"
        if roles and roles[dim] == "lane":
            raise CompileError(f"{where} sorts across lanes; the template "
                               "sorts a per-lane value axis only")
        x = self.value(args[0])
        if x.k is None or not roles or roles[dim] != "v":
            return x, desc, None
        if not self.fits(x.k):
            raise CompileError(
                f"{where} sorts a row of {x.k} elements, longer than one "
                "register tile; the template sorts a row held whole")
        return x, desc, self.full_scope(x.k)

    def _argsort(self, n) -> _Val:
        """The indices of ``sort(x)``: ``tl.sort`` of one 64-bit key per
        position of the row held in one register tile.  The key's high half
        is the value's bits mapped so that integer order is the values'
        order (-0.0 equal to 0.0, every NaN after +inf, as ``torch.sort``
        and ``jnp.argsort`` order them; complemented for a descending
        sort), its low half the position, so equal values keep their order
        (stable, as ``jnp.argsort`` is and the plain path's sorts are made,
        :class:`~repro_torch.core.context._ZeroDimRoll`); padding takes the
        largest key.  The indices are the sorted keys' low half."""
        x, desc, sc = self._sort_row(n)
        it = n.meta["val"][1].dtype
        if sc is None:                      # a sort of one element
            return _Val(const=0, dtype=it)
        od, k = x.dtype, x.k
        if od in (torch.float32, torch.float16, torch.bfloat16):
            xf = self.emit(self.cast(x, torch.float32, sc), torch.float32,
                           x.lane, k).expr
            xf = self.emit(f"tl.where({xf} == 0, 0.0, {xf})", torch.float32,
                           x.lane, k).expr
            b = self.emit(f"tl.where({xf} != {xf}, 2147483647, "
                          f"{xf}.to(tl.int32, bitcast=True))", torch.int32,
                          x.lane, k).expr
            hi = f"tl.where({b} < 0, {b} ^ 2147483647, {b})"
        elif od in (torch.int32, torch.int16, torch.int8, torch.uint8,
                    torch.bool):
            hi = self.cast(x, torch.int32, sc)
        else:
            raise CompileError(
                f"span kernel: aten.sort's indices of {od} values in "
                f"{self.plan.name!r} are not supported by the Triton "
                "template (a value must fit the 32-bit half of a key)")
        hi = self.emit(f"(-1 - {hi})" if desc else hi, torch.int32, x.lane,
                       k).expr
        key = self.emit(
            f"tl.where({sc.m}, ({hi}.to(tl.int64) << 32) | "
            f"{sc.r}.to(tl.int64), 9223372036854775807)", torch.int64,
            x.lane, k).expr
        self.flops += k * (4 + max(1, sc.bt.bit_length() - 1))
        srt = self.emit(f"tl.sort({key}, dim=1)", torch.int64, x.lane,
                        k).expr
        v = self.emit(f"({srt} & 4294967295).to({_TL[it]})", it, x.lane, k)
        v.scope = sc
        return v

    def _sort(self, n) -> _Val:
        """The values of ``sort(x)`` along a per-lane value axis that fits
        one register tile: ``tl.sort`` of the row padded to a power of two
        with +inf (-inf descending), so the padding sorts last."""
        x, desc, sc = self._sort_row(n)
        if sc is None:
            return x                        # a sort of one element
        k, od = x.k, x.dtype
        if od.is_floating_point:
            pad = '-float("inf")' if desc else 'float("inf")'
        else:
            info = torch.iinfo(od)
            pad = str(info.min if desc else info.max)
        e = self.emit(f"tl.where({sc.m}, {self.tile(x, sc)}, {pad})", od,
                      x.lane, k).expr
        self.flops += k * max(1, sc.bt.bit_length() - 1)
        v = self.emit(f"tl.sort({e}, dim=1, descending={desc})", od, x.lane,
                      k)
        v.scope = sc
        return v

    def _roll(self, n) -> _Val:
        """``roll(x, s)`` along a per-lane value axis of length ``k``:
        position ``r`` holds ``x`` at ``(r - s) mod k``, so the result is
        ``x`` emitted again in a scope whose positions are shifted (a
        load reads the wrapped positions, a product the wrapped columns
        of its matrix, a forwarded register tile its producer's value).
        A value with no value axis (a lane scalar: vmap rolls it across
        the lanes) rolls to itself, as ``torch.roll`` of a 0-d tensor
        does.  A roll across lanes of a value with a value axis, or a
        flattened roll of several axes, raises."""
        roles = self.roles[n.args[0]]
        shifts = list(n.args[1])
        dims = list(n.args[2]) if len(n.args) > 2 else []
        where = f"span kernel: aten.roll in {self.plan.name!r}"
        if not dims:                # a flattened roll: one axis of size > 1
            if len(shifts) != 1 or sum(r != "1" for r in roles) > 1:
                raise CompileError(f"{where} over a flattened value of "
                                   "several axes")
            dims = [next((d for d, r in enumerate(roles) if r != "1"), 0)]
        x = self.value(n.args[0])
        if x.k is None:
            return x
        shift = 0
        for s, d in zip(shifts, dims):
            role = roles[d % len(roles)] if roles else "1"
            if role == "lane":
                raise CompileError(f"{where} rolls a row across lanes; the "
                                   "template rolls a per-lane value axis "
                                   "only")
            if role == "v":
                shift += s
        k = x.k
        shift %= k
        if shift == 0:
            return x
        if x.scan is not None:
            return self._rolled_scan(x, shift)

        def emit_in(scope):
            return self.tile(x, self._rolled(scope, shift))
        return _Val(dtype=x.dtype, lane=x.lane, k=k, lazy=emit_in,
                    loop=x.loop)

    @staticmethod
    def _rolled(scope: _Scope, shift: int) -> _Scope:
        """``scope``'s positions rolled by ``shift``: position ``r`` reads
        ``(r - shift) mod k`` (one scope per shift, kept in ``scope``)."""
        rolled = scope.cache.get(("roll", shift))
        if rolled is None:
            k = scope.length
            rolled = scope.cache[("roll", shift)] = _Scope(
                k, f"(({scope.r} + {k - shift}) % {k})", scope.m, scope.bt,
                scope.start)
        return rolled

    def _scan_of(self, op: str, at) -> _Scan:
        """Scan ``op`` in type ``at``; its combine function (and CUDA's
        libdevice, which log-add-exp calls) is placed in the source."""
        s = _Scan(op, at)
        if s.fn is not None:
            self.combiners[s.fn] = None
            self.libdevice |= op == "lse"
        return s

    def _rolled_scan(self, c: _Val, shift: int) -> _Val:
        """``roll(scan(x), s)`` along a value axis of length ``k``, in
        linear time (``scan``: any of :data:`_SCAN_OPS`).  Position ``r``
        holds the scan at ``p = (r - s) mod k``: for ``r >= s`` the scan
        of ``x`` at the rolled positions ``s..r``, for ``r < s`` the
        aggregate ``P`` of ``x`` before position ``k - s`` combined with
        the scan of ``x`` at the rolled positions ``0..r``.  So a scope
        whose tiles run in order from 0 scans the rolled row as two
        segments, each carried from tile to tile, the second from ``P``
        (a pass emitted before the scope's loop); the grid's value tile
        scans its own positions (:meth:`_tile_scan`); one position takes
        the scan's own value there."""
        x, at, op = c.scan
        so = self._scan_of(op, at)
        k, od = c.k, c.dtype
        rows = self.block if x.lane else 1
        self.flops += k

        def emit_in(scope):
            rolled = self._rolled(scope, shift)
            if scope is self.grid_scope:
                return self._tile_scan(x, at, od, scope, shift, op)
            if not scope.seq:
                return self.tile(c, rolled)
            bound = [str(k - shift)]
            if scope.pre is None:           # the whole axis in one tile
                pv, = self._sums_before(x, at, bound, op)
            else:
                pv, = self._before_loop(
                    scope, lambda: self._sums_before(x, at, bound, op))
            xr = self.cast(x, at, rolled)
            hi = f"({scope.r} >= {shift})"
            e_hi = self.emit(f"tl.where({scope.m} & {hi}, {xr}, {so.ident})",
                             at, x.lane, k).expr
            e_lo = self.emit(f"tl.where({scope.m} & ({scope.r} < {shift}), "
                             f"{xr}, {so.ident})", at, x.lane, k).expr
            cs_hi = self.emit(so.scan(e_hi), at, x.lane, k).expr
            cs_lo = self.emit(so.scan(e_lo), at, x.lane, k).expr
            if scope.pre is None:
                out = f"tl.where({hi}, {cs_hi}, {so.comb(cs_lo, pv)})"
            else:
                c_hi, c_lo = f"c{self.n}", f"c{self.n + 1}"
                self.n += 2
                pre, ind = scope.pre
                pre.append(f"{ind}{c_hi} = {self._filled(so, rows)}")
                pre.append(f"{ind}{c_lo} = {pv}")
                out = (f"tl.where({hi}, {so.comb(cs_hi, c_hi)}, "
                       f"{so.comb(cs_lo, c_lo)})")
            v = self.emit(out if at == od else f"({out}).to({_TL[od]})", od,
                          x.lane, k).expr
            if scope.pre is not None:
                for cv, e, cs in ((c_hi, e_hi, cs_hi), (c_lo, e_lo, cs_lo)):
                    self._line(f"{cv} = "
                               + so.comb(cv, self._total(so, e, cs,
                                                         scope.bt)))
            return v
        return _Val(dtype=od, lane=c.lane, k=k, lazy=emit_in, loop=c.loop)

    @staticmethod
    def _filled(so: _Scan, rows: int) -> str:
        """A ``[rows, 1]`` column of the identity of scan ``so``."""
        if so.op == "sum":
            return f"tl.zeros([{rows}, 1], {_TL[so.at]})"
        return f"tl.full([{rows}, 1], {so.ident}, {_TL[so.at]})"

    @staticmethod
    def _total(so: _Scan, e: str, cs: str, bt: int, axis: int = 1) -> str:
        """The aggregate of tile ``e`` per lane along ``axis`` (``cs``: its
        scan there): its sum, or the scan's last position (padding
        positions hold the identity)."""
        if so.op == "sum":
            return f"tl.sum({e}, axis={axis})" + ("[:, None]" if axis == 1
                                                  else "")
        last = (f"tl.arange(0, {bt})[None, :]" if axis == 1
                else f"tl.arange(0, {bt})[None, None, :]")
        out = f"tl.sum(tl.where({last} == {bt - 1}, {cs}, 0), axis={axis})"
        return out + ("[:, None]" if axis == 1 else "")

    def _sums_before(self, x: _Val, at, bounds, op: str = "sum") -> list:
        """Per lane, the aggregate (of scan ``op``) of ``x`` over its
        positions below each of ``bounds`` (expressions), in type ``at``:
        one pass over the axis, the whole tile where it fits, else tile by
        tile."""
        k, rows = x.k, self.block if x.lane else 1
        so = self._scan_of(op, at)

        def part(sc, b):
            e = f"tl.where({sc.m} & ({sc.r} < {b}), {self.cast(x, at, sc)}, " \
                f"{so.ident})"
            return self._total(so, e, so.scan(e), sc.bt)
        if self.fits(k):
            sc = self.full_scope(k)
            return [self.emit(part(sc, b), at, x.lane, None).expr
                    for b in bounds]
        sums = [self.emit(self._filled(so, rows), at, x.lane,
                          None).expr for _ in bounds]
        with self.tiles_of(k) as sc:
            for v, b in zip(sums, bounds):
                self._line(f"{v} = {so.comb(v, part(sc, b))}")
        return sums

    def _before_loop(self, scope: _Scope, emit):
        """``emit()``'s lines placed before the loop of ``scope`` (with its
        carries' initial values), where they run once; returns what
        ``emit`` returns."""
        pre, ind = scope.pre
        saved = self.lines, self.ind
        self.lines, self.ind = [], ind[4:]
        try:
            out = emit()
        finally:
            lines = self.lines
            self.lines, self.ind = saved
        pre.extend(_flat(lines))
        return out

    def _tile_scan(self, x: _Val, at, od, scope: _Scope, shift: int,
                   op: str = "sum") -> str:
        """``roll(scan(x), shift)`` (``shift`` 0: the scan itself) at the
        positions ``start + arange(bt)`` of a tile that does not follow the
        tiles before it (the grid's value tile): the scan of the tile, in
        two segments where the roll wraps inside it (positions below
        ``shift`` read the row's end), each segment starting from the
        aggregate of ``x`` before its first position, found in one pass."""
        so = self._scan_of(op, at)
        k = scope.length
        start = scope.start
        hi = f"({scope.r} >= {shift})"
        bounds = [f"tl.maximum({start} - {shift}, 0)" if shift else start]
        if shift:
            bounds.append(f"({start} + {k - shift})")
        base = self._sums_before(x, at, bounds, op)
        xr = self.cast(x, at, self._rolled(scope, shift) if shift else scope)
        segs = []
        conds = (f" & {hi}", f" & ({scope.r} < {shift})") if shift else ("",)
        for cond, b in zip(conds, base):
            e = self.emit(f"tl.where({scope.m}{cond}, {xr}, {so.ident})", at,
                          x.lane, k).expr
            segs.append(self.emit(so.comb(so.scan(e), b), at, x.lane,
                                  k).expr)
        out = segs[0] if len(segs) == 1 else \
            f"tl.where({hi}, {segs[0]}, {segs[1]})"
        return self.emit(out if at == od else f"({out}).to({_TL[od]})", od,
                         x.lane, k).expr

    def _cumsum(self, n, x: _Val, od, op: str = "sum") -> _Val:
        """A scan of ``x`` along a per-lane value axis of length ``k``
        (``op``, a key of :data:`_SCAN_OPS`: ``cumsum``, ``cumprod``, the
        values of ``cummax``/``cummin``, ``logcumsumexp``), in float32
        (integers in their own type).  In a scope whose tiles run in order
        from position 0 (the whole axis, or a loop over its tiles) it is
        the scan of the tile combined with the running aggregate of the
        tiles before, carried from tile to tile; in the grid's value tile
        the scan of the tile from the aggregate of the positions before it
        (:meth:`_tile_scan`); in any other scope (one position, rolled
        positions that :meth:`_rolled_scan` does not scan again) the
        aggregate over every tile of ``x`` of its positions at or before
        each of the scope's.  A scan across lanes raises."""
        name = _SCAN_OPS[op]
        roles = self.roles[n.args[0]]
        dim = n.args[1] % len(roles) if roles else 0
        if roles and roles[dim] == "lane":
            raise CompileError(
                f"span kernel: {name} in {self.plan.name!r} scans "
                "across lanes; the template scans a per-lane value axis "
                "only")
        if x.k is None or not roles or roles[dim] != "v":
            # a scan over an axis of one element: the value itself
            return self.pointwise(lambda e: e, [(x, od)], od, x.lane, x.k, 0)
        k = x.k
        self.flops += k * (4 if op == "lse" else 1)
        at = torch.float32 if od.is_floating_point else od
        so = self._scan_of(op, at)
        rows = self.block if x.lane else 1

        def done(e):
            return e if at == od else f"{e}.to({_TL[od]})"

        def emit_in(scope):
            if scope.seq:
                e = self.emit(f"tl.where({scope.m}, {self.cast(x, at, scope)}"
                              f", {so.ident})", at, x.lane, k).expr
                cs = self.emit(so.scan(e), at, x.lane, k).expr
                if scope.pre is None:       # the whole axis in one tile
                    return cs if at == od else self.emit(
                        done(cs), od, x.lane, k).expr
                carry = f"c{self.n}"
                self.n += 1
                pre, ind = scope.pre
                pre.append(f"{ind}{carry} = {self._filled(so, rows)}")
                out = self.emit(done(so.comb(cs, carry)), od, x.lane,
                                k).expr
                self._line(f"{carry} = " + so.comb(
                    carry, self._total(so, e, cs, scope.bt)))
                return out
            if scope is self.grid_scope:
                return self._tile_scan(x, at, od, scope, 0, op)
            acc = self.emit(
                f"tl.zeros([{rows}, {scope.bt}], {_TL[at]})" if op == "sum"
                else f"tl.full([{rows}, {scope.bt}], {so.ident}, {_TL[at]})",
                at, x.lane, k).expr
            cap = max(1, _MAX_TILE_ELEMS // (rows * scope.bt))
            bt = min(pow2_at_least(k), 1 << (cap.bit_length() - 1))
            with self.tiles_of(k, bt) as sx:
                e = self.cast(x, at, sx)
                sel = (f"tl.where(({sx.r}[:, None, :] <= "
                       f"({scope.r})[:, :, None]) & {sx.m}[:, None, :], "
                       f"({e})[:, None, :], {so.ident})")
                if op == "sum":
                    self._line(f"{acc} += tl.sum({sel}, axis=2)")
                else:
                    self._line(f"{acc} = " + so.comb(acc, self._total(
                        so, sel, so.scan(sel, 2), bt, axis=2)))
            return self.emit(done(acc), od, x.lane, k).expr
        return _Val(dtype=od, lane=x.lane, k=k, lazy=emit_in, loop=x.loop,
                    scan=(x, at, op))

    def _select(self, n, x: _Val) -> _Val:
        roles = self.roles[n.args[0]]
        dim = n.args[1] % len(roles)
        if roles[dim] == "lane":
            raise CompileError(
                f"span kernel: select across lanes in {self.plan.name!r}")
        if roles[dim] == "1":
            return dataclasses.replace(x)
        k = x.k
        idx = n.args[2] + k if n.args[2] < 0 else n.args[2]
        if self.fits(k):
            sc = self.full_scope(k)
            return self.emit(f"tl.sum(tl.where({sc.r} == {idx}, "
                             f"{self.tile(x, sc)}, 0), axis=1)[:, None]",
                             x.dtype, x.lane, None)
        # one position of a tiled axis: a tile of width 1
        pos = self.emit(f"tl.full([1, 1], {idx}, tl.int32)", torch.int32,
                        False, None).expr
        return _Val(self.tile(x, _Scope(k, pos, f"({pos} < {k})", 1)),
                    x.dtype, lane=x.lane)

    def _reduce(self, n, kind, x: _Val, od, lane) -> _Val:
        roles = self.roles[n.args[0]]
        dims = n.args[1] if len(n.args) > 1 else list(range(len(roles)))
        if dims is None or dims == []:
            dims = list(range(len(roles)))
        dims = [d % len(roles) for d in dims] if roles else []
        if any(roles[d] == "lane" for d in dims):
            raise CompileError(
                f"span kernel: reduction across lanes in {self.plan.name!r}")
        vdims = [d for d in dims if roles[d] == "v"]
        if not vdims:
            return self.emit(self.cast(x, od), od, lane, None)
        size = n.args[0].meta["val"].shape[vdims[0]]
        if x.k is None:     # a lane scalar broadcast along the reduced axis
            e = self.cast(x, od)
            e = f"({e} * {size})" if kind == "sum" else e
            return self.emit(e, od, x.lane, None)
        k = x.k
        self.flops += k
        op = "sum" if kind == "mean" else kind
        if op == "sum":
            ident = "0"
        else:
            ident = 'float("inf")' if od.is_floating_point else str(
                torch.iinfo(od).max)
            if op == "max":
                ident = "-" + ident if od.is_floating_point else str(
                    torch.iinfo(od).min)

        def part(sc):
            return (f"tl.{op}(tl.where({sc.m}, {self.cast(x, od, sc)}, "
                    f"{ident}), axis=1)[:, None]")
        if self.fits(k):
            v = self.emit(part(self.full_scope(k)), od, x.lane, None)
        else:
            # the first pass over the axis, tile by tile
            rows = self.block if x.lane else 1
            v = self.emit(f"tl.full([{rows}, 1], {ident}, {_TL[od]})", od,
                          x.lane, None)
            with self.tiles_of(k) as sc:
                p = part(sc)
                self._line(f"{v.expr} = ({v.expr} + {p})" if op == "sum" else
                           f"{v.expr} = tl.{op}imum({v.expr}, {p})")
        if kind == "mean":
            v = self.emit(f"({v.expr} / {_lit(k, od)})", od, x.lane, None)
        return v

    # -- products -----------------------------------------------------------

    def _dot_type(self, *dts) -> tuple:
        """The operand type of a product and its ``tl.dot`` options, by
        the reference's promotion (``jnp.dot``): integer operands alone
        multiply in their promoted integer type, as row sums (options
        ``None``: no ``tl.dot`` takes them), and wrap as int32 products
        do in both packages; an integer beside a float takes the float's
        type; 16-bit floats of one type stay as they are (tensor cores,
        float32 accumulator); anything else is float32 at
        :data:`_F32_PRECISION`, stated on every such dot."""
        if torch.bool in dts:
            raise CompileError(
                f"span kernel: a product of torch.bool operands in "
                f"{self.plan.name!r}")
        floats = {dt for dt in dts if dt.is_floating_point}
        if not floats:
            return functools.reduce(torch.promote_types, dts), None
        for dt in floats:
            if dt not in (torch.float32, torch.float16, torch.bfloat16):
                raise CompileError(
                    f"span kernel: a product of {dt} operands in "
                    f"{self.plan.name!r}; tl.dot takes float32 and 16-bit "
                    "floats")
        if len(floats) == 1 and floats <= {torch.float16, torch.bfloat16}:
            return floats.pop(), ""
        return torch.float32, f', input_precision="{_F32_PRECISION}"'

    def _mem_type(self, mem: _Mem):
        """The type a product reads ``env[mem.key]`` in: the body's cast
        of it, else its own."""
        return mem.dtype or self.plan.context.vars[mem.key].dtype

    def _product(self, n) -> _Val:
        """``aten.mm``/``aten.mv`` with one per-lane operand (a row of the
        lane, loaded or computed) and one replicated env array, either
        side and either orientation; or, in a rank-2 nest, the outer tile
        of a row per i-lane and a column per j-lane."""
        t = n.target
        x, y = (self.vals[a] for a in n.args[:2])
        od = n.meta["val"].dtype
        where = (f"span kernel: {t} in {self.plan.name!r}")
        if t is aten.mv.default:
            if x.mem is None and x.lane and x.k is not None \
                    and y.mem is not None and len(y.mem.remaining) == 1:
                return self._mv(x, y.mem, y.mem.remaining[0], od)
            raise CompileError(f"{where}: the template multiplies a per-lane "
                               "row by a replicated vector")
        if x.mem is None and x.lane and y.mem is not None \
                and len(y.mem.remaining) == 2:          # rows @ B
            d_k, d_n = y.mem.remaining
            return self._mm(x, y.mem, d_k, d_n, od)
        if y.mem is None and y.lane and x.mem is not None \
                and len(x.mem.remaining) == 2:          # B @ rows^T
            d_n, d_k = x.mem.remaining
            return self._mm(y, x.mem, d_k, d_n, od)
        if self.rank == 2 and x.mem is None and y.mem is None and x.lane \
                and y.lane and self.roles[n].count("lane") == 2:
            return self._outer(x, y, od, where)
        raise CompileError(
            f"{where}: the template multiplies a per-lane row by a "
            "replicated matrix (or, in a rank-2 nest, an i-row by a j-column)")

    def _replicated(self, mem: _Mem, what: str) -> None:
        dec = self.plan.vars[mem.key]
        if mem.key in self.forwarded or dec.in_strategy in ("shard",
                                                            "shard_halo"):
            raise CompileError(
                f"span kernel: the {what} operand env[{mem.key!r}] of a "
                f"product in {self.plan.name!r} is not a replicated array")

    def _k_loop(self, acc: str, k: int, bk: int, body, m: int, n: int,
                dt) -> None:
        """``acc = tl.dot(a, b, acc)`` over the K tiles of length ``k``:
        ``body(kscope, kcol)`` returns the two operand expressions for a
        K tile (``kscope``: positions ``[1, bk]``; ``kcol``: the same
        positions as ``[bk, 1]``), ``[m, bk]`` and ``[bk, n]`` of type
        ``dt``: one stage of the ring, ``bk`` halved while
        ``_DOT_STAGES`` of them exceed ``_SMEM_BYTES``."""
        size = torch.empty((), dtype=dt).element_size()
        while bk > _DOT_MIN and \
                _DOT_STAGES * (m + n) * bk * size > _SMEM_BYTES:
            bk //= 2
        with self.tiles_of(k, bk) as ks:
            kcol = f"{ks.r}c"
            self._line(f"{kcol} = {ks.start} + tl.arange(0, {bk})[:, None]")
            a, b, opts = body(ks, kcol)
            self._line(f"{acc} = tl.dot({a}, {b}, {acc}{opts})")

    @staticmethod
    def _k_contiguous(mem: _Mem, d_k: int, d_n: int) -> bool:
        """Whether a product's matrix runs along K in memory."""
        return math.prod(mem.shape[d_k + 1:]) < math.prod(mem.shape[d_n + 1:])

    @staticmethod
    def _wants_k_major(dt) -> bool:
        """Whether a product's ``tl.dot`` reads its matrix's tiles fastest
        along K: float32 on the tensor cores (TF32 ``wgmma`` takes a
        K-major B tile; Triton turns an N-major one into a slower path,
        2.2-2.4x on the H100, ``tools/k1_product_variants.py``); else
        along N (the FMA ``tl.dot``'s shared tile is not swizzled for a
        K-major read: 2.9x slower; 16-bit operands keep that rule)."""
        return dt == torch.float32 and _F32_PRECISION != "ieee"

    def _mm(self, row: _Val, mem: _Mem, d_k: int, d_n: int, od) -> _Val:
        self._replicated(mem, "matrix")
        k, nn = mem.extent(d_k), mem.extent(d_n)
        if row.k != k:
            raise CompileError(
                f"span kernel: a product in {self.plan.name!r} contracts a "
                f"per-lane row of {row.k} with {k} rows of env[{mem.key!r}]")
        if nn == 1:
            # one output position a lane: the matrix's one column is a
            # vector, and the product a matrix-vector row sum
            starts = dict(mem.starts)
            first = starts.pop(d_n, (0, 1))[0]
            return self._mv(row, dataclasses.replace(
                mem, fixed={**mem.fixed, d_n: first}, starts=starts,
                remaining=[d_k]), d_k, od)
        dt, opts = self._dot_type(row.dtype, self._mem_type(mem))
        bk = min(max(pow2_at_least(k), _DOT_MIN),
                 _BK_ONE if self.shape.products == 1 else _BK)
        last = len(mem.shape) - 2
        if opts is not None and not mem.starts \
                and self._k_contiguous(mem, d_k, d_n) != self._wants_k_major(
                    dt) and {d_k, d_n} == {last, last + 1}:
            # a matrix whose tiles run the other way than the dot reads
            # them fastest (under 3xTF32 gemm's B; in IEEE, A.T in syrk
            # and covariance's rows): the kernel is handed its transpose,
            # copied by kernel_args, and reads that the fast way
            swap = {last: last + 1, last + 1: last}
            mem = dataclasses.replace(
                mem, shape=mem.shape[:last] + mem.shape[last:][::-1],
                remaining=[])
            d_k, d_n, kind = swap[d_k], swap[d_n], "replT"
        else:
            kind = None
        p, off = self._address(mem, {d_k: "@K@", d_n: "@R@"}, kind)
        block = self.block

        def emit_in(scope):
            # the output positions this scope computes: one, or all nn
            work = 2 * k * (nn if scope.start is not None else scope.bt)
            self.flops += work
            if opts is None or scope.bt < _DOT_MIN:
                return self._row_sums(row, p, off, k, scope, dt, od)
            self.dot_flops += work
            acc = f"acc{self.n}"
            self.n += 1
            self._line(f"{acc} = tl.zeros([{block}, {scope.bt}], tl.float32)")

            def body(ks, kcol):
                a = self.cast(row, dt, ks)
                a = self.emit(f"tl.broadcast_to({a}, [{block}, {ks.bt}])",
                              dt, True, k).expr
                o = off.replace("@K@", kcol).replace("@R@", scope.r)
                b = self.emit(f"tl.load({p} + {o}, mask=({kcol} < {k}) & "
                              f"{scope.m}, other=0).to({_TL[dt]})", dt, False,
                              None).expr
                return a, b, opts
            self._k_loop(acc, k, bk, body, block, scope.bt, dt)
            return self.emit(f"{acc}.to({_TL[od]})", od, True, nn).expr
        return _Val(dtype=od, lane=True, k=nn, lazy=emit_in, loop=True)

    def _row_sums(self, row: _Val, p: str, off: str, k: int, scope: _Scope,
                  dt, od) -> str:
        """``row @ matrix`` at the output positions of ``scope`` without
        ``tl.dot`` (integer operands, or fewer than 16 positions): each K
        tile of the row times the matrix's ``[bk, bt]`` tile, summed over
        K per position in float32 (an integer type: in it, wrapping as
        ``jnp.dot``'s int32 products do), then over the tile's K positions
        once; ``bk`` keeps the ``[lanes, bk, bt]`` sums within one
        register tile."""
        at = dt if not dt.is_floating_point else torch.float32
        cap = max(1, _MAX_TILE_ELEMS // (self.block * scope.bt))
        bk = min(pow2_at_least(k), _BK_MV, 1 << (cap.bit_length() - 1))
        acc = f"acc{self.n}"
        self.n += 1
        self._line(f"{acc} = tl.zeros([{self.block}, {bk}, {scope.bt}], "
                   f"{_TL[at]})")
        with self.tiles_of(k, bk, _MV_STAGES) as ks:
            kcol = f"{ks.r}c"
            self._line(f"{kcol} = {ks.start} + tl.arange(0, {bk})[:, None]")
            a = self.emit(f"tl.where({ks.m}, {self.cast(row, at, ks)}, 0)",
                          at, True, k).expr
            o = off.replace("@K@", kcol).replace("@R@", scope.r)
            b = self.emit(f"tl.load({p} + {o}, mask=({kcol} < {k}) & "
                          f"{scope.m}, other=0).to({_TL[at]})", at, False,
                          None).expr
            self._line(f"{acc} += {a}[:, :, None] * {b}[None, :, :]")
        return self.emit(f"tl.sum({acc}, axis=1).to({_TL[od]})", od, True,
                         scope.length).expr

    def _mv(self, row: _Val, mem: _Mem, d_k: int, od) -> _Val:
        """A per-lane row times a replicated vector: the rows' K tiles
        times the vector's (``[lanes, bk] * [1, bk]``, the vector tile
        loaded once a K step for every lane), summed over K per position
        in float32 (integer operands: in their integer type, wrapping),
        then over the tile's positions once; the loop's loads pipelined
        ``_MV_STAGES`` deep.  The order of the sums is fixed, so repeated
        launches give the same bits."""
        self._replicated(mem, "vector")
        k = mem.extent(d_k)
        if row.k != k:
            raise CompileError(
                f"span kernel: a product in {self.plan.name!r} contracts a "
                f"per-lane row of {row.k} with env[{mem.key!r}] of {k}")
        dt, opts = self._dot_type(row.dtype, self._mem_type(mem))
        at = torch.float32 if opts is not None else dt
        bk = min(pow2_at_least(k), _BK_MV)
        self.flops += 2 * k
        p, off = self._address(mem, {d_k: "@K@"})
        acc = f"acc{self.n}"
        self.n += 1
        self._line(f"{acc} = tl.zeros([{self.block}, {bk}], {_TL[at]})")
        with self.tiles_of(k, bk, _MV_STAGES) as ks:
            a = self.cast(row, at, ks)
            b = self.emit(f"tl.load({p} + {off.replace('@K@', ks.r)}, "
                          f"mask={ks.m}, other=0).to({_TL[at]})", at,
                          False, None).expr
            self._line(f"{acc} += {a} * {b}")
        return self.emit(f"tl.sum({acc}, axis=1)[:, None].to({_TL[od]})", od,
                         True, None)

    def _iter_vec(self, d: int) -> str:
        """The stage's iterator over the tile's own lanes of axis ``d``
        alone: ``[tile_i, 1]`` for i, ``[1, tile_j]`` for j."""
        tag = (self.si, d)
        if tag not in self.iter_vecs:
            loop = self.plan.nest.axes[d]
            ch, tl_ = self.plan.chunks_axes[d], self.tiles[d]
            s, t = (self.gslot, "ti") if d == 0 else ("sj", "tj")
            shape = "[:, None]" if d == 0 else "[None, :]"
            name = f"{'ij'[d]}v{self.si}"
            self.head.append(
                f"    {name} = ({loop.start} + {loop.step} * tl.minimum("
                f"{s} * {ch.chunk} + {t} * {tl_.tile} + tl.arange(0, "
                f"{tl_.tile}){shape}, {loop.trip_count - 1})).to(tl.int32)")
            self.iter_vecs[tag] = name
        return self.iter_vecs[tag]

    def _outer_operand(self, v: _Val, axis: int, where: str):
        """Pointer, offset (``@K@`` for the contracted axis) and length of
        a rank-2 product's operand: a row of env read at an index affine
        in the iterator of nest axis ``axis`` alone."""
        if v.src is None:
            raise CompileError(f"{where}: a rank-2 product of a computed "
                               "operand; the template reads env rows")
        mem, index, d_k = v.src
        (d, ix), = index.items() if len(index) == 1 else ((None, None),)
        if ix is None or ix.aff is None or ix.aff[0] != axis:
            raise CompileError(f"{where}: an operand's row index is not "
                               f"affine in nest axis {axis}")
        _, a, b = ix.aff
        iv = self._iter_vec(axis)
        # the index over this tile's lanes of one axis: a * iterator + b
        e = self.emit(f"({a} * {iv} + {b})", torch.int32, True, None)
        p, off = self._address(mem, {d: e, d_k: "@K@"})
        return p, off, mem.shape[d_k], self._mem_type(mem)

    def _outer(self, x: _Val, y: _Val, od, where) -> _Val:
        pa, offa, k, dta = self._outer_operand(x, 0, where)
        pb, offb, kb, dtb = self._outer_operand(y, 1, where)
        if k != kb:
            raise CompileError(f"{where}: operands of {k} and {kb}")
        dt, opts = self._dot_type(dta, dtb)
        ti, tj = (t.tile for t in self.tiles)
        self.flops += 2 * k
        acc = f"acc{self.n}"
        self.n += 1
        if opts is None:
            # integer operands: [ti, bk] x [bk, tj] row sums in their type
            cap = max(1, _MAX_TILE_ELEMS // (ti * tj))
            bk = min(pow2_at_least(k), 1 << (cap.bit_length() - 1))
            self._line(f"{acc} = tl.zeros([{ti}, {bk}, {tj}], {_TL[dt]})")
        else:
            bk = min(max(pow2_at_least(k), _DOT_MIN), _BK)
            self.dot_flops += 2 * k
            self._line(f"{acc} = tl.zeros([{ti}, {tj}], tl.float32)")

        def body(ks, kcol):
            a = self.emit(f"tl.load({pa} + {offa.replace('@K@', ks.r)}, "
                          f"mask={ks.m}, other=0).to({_TL[dt]})", dt, True,
                          k).expr
            b = self.emit(f"tl.load({pb} + {offb.replace('@K@', kcol)}, "
                          f"mask={kcol} < {k}, other=0).to({_TL[dt]})", dt,
                          True, k).expr
            return a, b, opts
        if opts is None:
            with self.tiles_of(k, bk) as ks:
                kcol = f"{ks.r}c"
                self._line(f"{kcol} = {ks.start} + tl.arange(0, {bk})"
                           "[:, None]")
                a, b, _ = body(ks, kcol)
                self._line(f"{acc} += {a}[:, :, None] * {b}[None, :, :]")
            acc = self.emit(f"tl.sum({acc}, axis=1)", dt, True, None).expr
        else:
            self._k_loop(acc, k, bk, body, ti, tj, dt)
        # [tile_i, tile_j] is the flat block's own order (f = li * tj + lj)
        return self.emit(f"tl.reshape({acc}, [{self.block}, 1])"
                         f".to({_TL[od]})", od, True, None)

    # -- stores -------------------------------------------------------------

    def store(self, key: str, leaf, out_ptr: str) -> None:
        info = self.plan.context.vars[key]
        vshape = tuple(info.write.value_shape)
        dt = info.write.value_dtype
        if len(vshape) > 1:
            raise CompileError(
                f"span kernel: {key!r} takes per-iteration values of shape "
                f"{vshape}; the template stores at most one value axis")
        v = self.value(leaf)
        dec = self.plan.vars[key]
        fwd = dec.out_strategy in ("identity", "partial")
        maps = ((dec.write_map,) if self.rank == 1 else dec.write_maps)
        bases = tuple(m.b for m in maps) if fwd else ()
        if self.rank == 1:
            c = self.plan.chunks.chunk
            base = f"(slot * {c} + lane)"
        else:
            ch_i, ch_j = self.plan.chunks_axes
            sj = ch_j.local_chunks * ch_j.num_devices
            base = (f"((si * {ch_i.chunk} + li) * {sj * ch_j.chunk} + "
                    f"sj * {ch_j.chunk} + lj)")
        gs = self.grid_scope
        # a program of the grid's value axis stores its own tile of that
        # axis; other values once, from value tile 0
        once = " & (vt == 0)" if gs is not None and not (
            vshape and vshape[0] == gs.length) else ""
        if not vshape:
            e = self.cast(v, dt)
            if v.const is not None:
                e = f"tl.full([{self.block}, 1], {e}, {_TL[dt]})"
            elif not v.lane:
                e = f"tl.where(lmask, {e}, {e})"
            if fwd:
                # the tile a later span stage reads in place of this output,
                # and where this stage wrote lane k on each axis (k + base)
                tile = self.emit(e, dt, True, None)
                self.fwd_vals[key] = (tile, bases, None)
                e = tile.expr
            self._line(f"tl.store({out_ptr} + {base}, {e}, mask=lmask{once})")
            return
        k = vshape[0]
        if gs is not None and k == gs.length:
            self._store_tile(v, gs, key, dt, fwd, bases, out_ptr, base, "")
        elif self.fits(k):
            self._store_tile(v, self.full_scope(k), key, dt, fwd, bases,
                             out_ptr, base, once)
        else:
            if fwd:
                # a later stage re-loads its rows (one program stored them
                # all, unless the grid's value axis splits the program)
                self.fwd_vals[key] = (None, bases, None if gs is not None
                                      else (out_ptr, base, k, dt))
            with self.tiles_of(k) as sc:
                self._store_tile(v, sc, key, dt, False, bases, out_ptr, base,
                                 once)

    def _store_tile(self, v, sc, key, dt, fwd, bases, out_ptr, base,
                    once) -> None:
        k = sc.length
        mask = f"lmask & {sc.m}{once}"
        e = self.cast(v, dt, sc)
        if v.const is not None:
            e = f"tl.full([{self.block}, {sc.bt}], {e}, {_TL[dt]})"
        elif not v.lane or v.k is None:
            # broadcast to the whole tile
            e = f"tl.where({mask}, {e}, {e})"
        if fwd:
            if sc is self.full_scopes.get(k):
                tile = self.emit(e, dt, True, k)
                tile.scope = sc
                # a later stage that reads the tile in another tiling (a
                # roll's wrapped positions) emits the stored value again
                tile.alt = _Val(dtype=dt, lane=True, k=k, loop=v.loop,
                                lazy=lambda s, v=v, dt=dt: self.cast(v, dt, s))
                self.fwd_vals[key] = (tile, bases, None)
                e = tile.expr
            else:
                self.fwd_vals[key] = (None, bases, None)
        self._line(f"tl.store({out_ptr} + {base} * {k} + {sc.r}, {e}, "
                   f"mask={mask})")


def _prologue(plan, tiles, wide: bool, value_tiles: int,
              gen: "_Gen") -> str:
    w = ".to(tl.int64)" if wide else ""
    vsplit = VSPLIT.format(nv=value_tiles) if value_tiles > 1 else ""
    local = "slot" if plan.rank == 1 else "si"
    window = "" if gen.window is None else WINDOW.format(
        g=gen.gslot, s=local, block=gen.window[0], p=gen.window[1])
    if plan.rank == 1:
        ch, loop = plan.chunks, plan.loop
        return PROLOGUE1.format(
            wide=w, vsplit=vsplit, nt=tiles[0].n_tiles, tile=tiles[0].tile,
            window=window, gslot=gen.gslot,
            c=ch.chunk, start=loop.start, step=loop.step,
            tmax=loop.trip_count - 1)
    (ch_i, ch_j), (lp_i, lp_j) = plan.chunks_axes, plan.nest.axes
    return PROLOGUE2.format(
        wide=w, vsplit=vsplit, window=window, gslot=gen.gslot,
        ntj=tiles[1].n_tiles, nti=tiles[0].n_tiles,
        nsj=live_slots(plan)[1],
        lanes=tiles[0].tile * tiles[1].tile, ti=tiles[0].tile,
        tj=tiles[1].tile, ci=ch_i.chunk, cj=ch_j.chunk,
        starti=lp_i.start, stepi=lp_i.step, tmaxi=lp_i.trip_count - 1,
        startj=lp_j.start, stepj=lp_j.step, tmaxj=lp_j.trip_count - 1)


def live_slots(plan) -> tuple[int, ...]:
    """Chunk slots per nest axis that hold an iteration: the grid's slot
    range.  Under the cyclic deal slot ``s`` starts at iteration ``s * c``,
    so the padding slots of ``num_chunks`` are the trailing ones and are
    never launched; their rows of the dense output stay unwritten (every
    merge reads the lanes that hold an iteration only)."""
    return tuple(-(-lp.trip_count // ch.chunk)
                 for lp, ch in zip(plan.nest.axes, plan.chunks_axes))


def window_slots(plan, block: int) -> int:
    """Live slots of the first nest axis in the rank window of ``block``
    ranks that holds the most: the windowed grid's slot range (every
    window ``(lo, block)`` of the cyclic deal, ``lo`` from 0 to ``P -
    block``)."""
    ch = plan.chunks_axes[0]
    live = live_slots(plan)[0]
    q = np.arange(ch.local_chunks)[:, None] * ch.num_devices
    return max(int(((q + lo + np.arange(block)) < live).sum())
               for lo in range(ch.num_devices - block + 1))


def _out_shape(plan, key, window=None) -> tuple:
    """A dense output's shape: ``(n_loc, P, c, ...)`` per nest axis, the
    first axis's ``P`` a rank window's ``block``."""
    vshape = tuple(plan.context.vars[key].write.value_shape)
    lead = []
    for d, ch in enumerate(plan.chunks_axes):
        ranks = window[0] if window is not None and d == 0 \
            else ch.num_devices
        lead += [ch.local_chunks, ranks, ch.chunk]
    return tuple(lead) + vshape


def _traces(plan, program, device):
    """The two traces of a stage's body (lane counts differ, so a graph
    dim that changes size between them is a lane dim)."""
    specs = {k: ctx_mod.TensorSpec(tuple(plan.context.vars[k].shape),
                                   plan.context.vars[k].dtype)
             for k in plan.context.env_keys}
    trace_a = plan.context.trace
    if trace_a is None or trace_a.lanes != ctx_mod.ANALYSIS_LANES[:plan.rank]:
        trace_a = ctx_mod.trace_body(program, specs, plan.rank,
                                     ctx_mod.ANALYSIS_LANES[:plan.rank],
                                     device)
    trace_b = ctx_mod.trace_body(program, specs, plan.rank,
                                 _LANES_B[:plan.rank], device)
    return trace_a, trace_b


def _check_span_geometry(plans) -> None:
    """Every stage of a span shares one chunk geometry, hence one tile
    and one grid of live slots: the generated prologue is plan 0's."""
    plan0 = plans[0]
    geom0 = [(ch.chunk, ch.num_devices, ch.local_chunks, ch.padded_trip)
             for ch in plan0.chunks_axes]
    for plan in plans[1:]:
        geom = [(ch.chunk, ch.num_devices, ch.local_chunks, ch.padded_trip)
                for ch in plan.chunks_axes]
        if (plan.rank != plan0.rank or geom != geom0
                or plan.nest.trip_counts != plan0.nest.trip_counts
                or live_slots(plan) != live_slots(plan0)):
            raise CompileError(
                f"span kernel: stages {plan0.name!r} and {plan.name!r} do "
                "not share one chunk geometry and cannot share a launch")


def _launch_shape(shape: _Shape) -> dict:
    """Warps and pipelining depth of a span's launch: 8 warps and a
    ``_DOT_STAGES``-deep operand ring for a row-times-matrix product (its
    K tile sized to fit shared memory, :meth:`_Gen._k_loop`);
    ``_MV_WARPS`` for a matrix-vector span (its K loop states its own
    depth); Triton's defaults otherwise."""
    if shape.vec is not None:
        return dict(num_warps=_DOT_WARPS, num_stages=_DOT_STAGES)
    if shape.mv and not (shape.dot or shape.outer):
        return dict(num_warps=_MV_WARPS)
    return {}


def generate(plan, program, device=None, block: int | None = None
             ) -> SpanSource:
    """The span kernel of one block (a span of one stage)."""
    return generate_span([(plan, program, frozenset())], device, block)


def generate_span(stages, device=None, block: int | None = None
                  ) -> SpanSource:
    """ONE span kernel for a chain of same-geometry stages, generated
    from their bodies' aten graphs in span order.  ``stages``: ``(plan,
    program, forwarded keys)`` per stage; a forwarded key is read from
    the register tile an earlier stage stored for the same lanes.  Every
    stage's written keys are stored in the global dense layout (a rank
    window's, for ``block`` ranks of the first nest axis: see the module
    docstring).  ``CompileError`` for a body the template cannot express,
    or a forwarded read that does not address the lane's own row."""
    plans = [plan for plan, _, _ in stages]
    if any(ch.slot_map is not None for plan in plans
           for ch in plan.chunks_axes):
        raise CompileError(
            "span kernel: straggler-weighted chunk plans run on the "
            "collective lowering only")
    _check_span_geometry(plans)
    device = torch.device("cpu") if device is None else device
    traces = [_traces(plan, program, device) for plan, program, _ in stages]
    gen = _Gen(plans, traces, block)
    outputs = []
    for si, ((plan, program, forwarded), (trace_a, _)) in enumerate(
            zip(stages, traces)):
        gen.stage(si, plan, trace_a, forwarded)
        for node in trace_a.graph.nodes:
            gen.node(node)
        updates = trace_a.updates()
        for key in plan.written_keys:
            gen.store(key, updates[key].value, f"o{si}_{len(outputs)}")
            outputs.append((si, key, _out_shape(plan, key, gen.window),
                            plan.context.vars[key].write.value_dtype))
    plan0 = plans[0]
    params = [f"p{si}_{i}" for i, (_, si, _) in enumerate(gen.inputs)] + \
        [f"o{si}_{i}" for i, (si, _, _, _) in enumerate(outputs)]
    if gen.window is not None:
        params = ["rank_lo"] + params
    lines = _flat(gen.lines)
    body = (_prologue(plan0, gen.tiles, gen.wide, gen.value_tiles, gen)
            + "".join(line + "\n" for line in gen.head)
            + "\n".join(lines) + "\n")
    digest = hashlib.sha256(
        (",".join(params) + body).encode()).hexdigest()[:16]
    fn_name = f"span_{digest}"
    names = "+".join(plan.name for plan in plans)
    text = (
        f'"""Span kernel of {names!r}, generated by '
        "repro_torch.kernels.span_kernel\nfrom the bodies' aten graphs; "
        'rebuilt on demand, never edited."""\n'
        "import triton\nimport triton.language as tl\n"
        + ("from triton.language.extra import libdevice\n"
           if gen.libdevice else "") + "\n\n"
        + "".join(f"@triton.jit\ndef {name}(a, b):\n{_COMBINERS[name]}\n\n"
                  for name in gen.combiners)
        + f"@triton.jit\ndef {fn_name}({', '.join(params)}):\n{body}")
    slots = list(live_slots(plan0))
    if gen.window is not None:
        slots[0] = window_slots(plan0, gen.window[0])
    n_prog = math.prod(slots) \
        * math.prod(t.n_tiles for t in gen.tiles) * gen.value_tiles
    return SpanSource(fn_name=fn_name, text=text, inputs=tuple(gen.inputs),
                      outputs=tuple(outputs), n_programs=n_prog,
                      flops_per_lane=gen.flops,
                      dot_flops_per_lane=gen.dot_flops,
                      forwarded=tuple(dict.fromkeys(gen.fwd_reads)),
                      tiles=gen.tiles, value_tiles=gen.value_tiles,
                      window=gen.window or (), **_launch_shape(gen.shape))


# ---------------------------------------------------------------------------
# Build + launch
# ---------------------------------------------------------------------------

_KERNELS: dict[str, Any] = {}


def _kernel(source: SpanSource):
    """The jitted kernel of ``source``: its module written under
    ``build/span_kernels/`` and imported from there; Triton compiles it
    for the card at first launch and caches under ``build/triton/``."""
    fn = _KERNELS.get(source.fn_name)
    if fn is not None:
        return fn
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton  # noqa: F401  (fails loudly where Triton is missing)

    path = BUILD_DIR / "span_kernels" / f"{source.fn_name}.py"
    path.parent.mkdir(parents=True, exist_ok=True)
    if not path.exists() or path.read_text() != source.text:
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(source.text)
        os.replace(tmp, path)
    spec = importlib.util.spec_from_file_location(source.fn_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    fn = _KERNELS[source.fn_name] = getattr(module, source.fn_name)
    return fn


_RANK_LO: dict = {}


def rank_lo(lo: int, device) -> torch.Tensor:
    """A rank window's first rank as the one-element int32 tensor a
    windowed kernel reads (one per ``(lo, device)``, kept)."""
    key = (int(lo), str(device))
    t = _RANK_LO.get(key)
    if t is None:
        t = _RANK_LO[key] = torch.tensor([int(lo)], dtype=torch.int32,
                                         device=device)
    return t


def kernel_args(source: SpanSource, stage_io, lo: int = 0,
                device=None) -> list:
    """The kernel's pointer arguments from ``stage_io`` (``(windows,
    env_repl)`` per stage): each input contiguous, and a matrix that a
    product reads transposed (kind ``"replT"``) as a contiguous copy with
    its last two dims swapped, so that the kernel's tiles of it run
    along N; a rank window's kernel takes its first rank ``lo`` first,
    on ``device`` (default: the inputs', or the CPU's)."""
    args = []
    for kind, si, key in source.inputs:
        t = stage_io[si][0 if kind == "win" else 1][key]
        args.append(t.transpose(-2, -1).contiguous() if kind == "replT"
                    else t.contiguous())
    if source.window:
        if device is None:
            device = args[0].device if args else torch.device("cpu")
        args.insert(0, rank_lo(lo, device))
    return args


def _stage_outputs(source: SpanSource, n_stages: int, tensors) -> list:
    outs = [{} for _ in range(n_stages)]
    for (si, key, _, _), t in zip(source.outputs, tensors):
        outs[si][key] = t
    return outs


def _warm(source: SpanSource, args, outs):
    """The compiled kernel of ``source`` for these arguments, loaded:
    Triton's ``JITFunction.warmup`` (compiled or taken from its cache,
    launching nothing) at the source's warps and pipelining depth."""
    k = _kernel(source).warmup(*args, *outs, grid=(source.n_programs,),
                               num_warps=source.num_warps,
                               num_stages=source.num_stages)
    k.run                                   # loads the module, sets smem
    return k


def launch_span_triton(source: SpanSource, stage_io, device,
                       lo: int = 0) -> list:
    """The span kernel launched through Triton's own Python path (its
    binder, specialisation and cache lookup on every call), into one
    ``torch.empty`` per output: the launch :func:`launch_span` replaced,
    kept as it was to hold the new launcher against it, bit for bit and
    in time.  Counts no launch."""
    fn = _kernel(source)
    args = kernel_args(source, stage_io, lo, device)
    flat = [torch.empty(shape, dtype=dtype, device=device)
            for _, _, shape, dtype in source.outputs]
    fn[(source.n_programs,)](*args, *flat, num_warps=source.num_warps,
                             num_stages=source.num_stages)
    return _stage_outputs(source, len(stage_io), flat)


#: Bytes of alignment on which Triton specialises a pointer argument
#: (its ``tt.divisibility``): a kernel compiled for aligned pointers may
#: use 16-byte loads, so a pointer off it needs another compiled kernel.
ALIGN = 16


def _bind_launch(lib) -> None:
    lib.k1_launch.argtypes = [ctypes.c_void_p]
    lib.k1_launch.restype = ctypes.c_int
    lib.k1_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                            ctypes.POINTER(ctypes.c_uint64)]
    lib.k1_load.restype = ctypes.c_int
    lib.k1_error_string.argtypes = [ctypes.c_int]
    lib.k1_error_string.restype = ctypes.c_char_p


_LAUNCH_LIB = _build.CudaLibrary("span_launch.cu", "K1's launcher",
                                 _bind_launch)


def output_layout(source: SpanSource) -> tuple[list[int], int]:
    """Where each output of ``source`` lies in the one allocation a launch
    makes: byte offsets, in output order, each a multiple of
    :data:`ALIGN`; and the allocation's size in bytes."""
    offsets, total = [], 0
    for _, _, shape, dtype in source.outputs:
        total = -(-total // ALIGN) * ALIGN
        offsets.append(total)
        total += math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    return offsets, total


def specialisation(ptrs) -> int:
    """The key of the compiled kernel a launch needs: bit ``i`` set where
    pointer ``i`` is off :data:`ALIGN` (a contiguous window view can
    start off it); 0 when all are on it, found in one pass."""
    if not functools.reduce(operator.or_, ptrs, 0) % ALIGN:
        return 0
    key = 0
    for i, p in enumerate(ptrs):
        if p % ALIGN:
            key |= 1 << i
    return key


@dataclasses.dataclass(frozen=True)
class _Compiled:
    """One compiled specialisation of a span kernel, as the launch needs
    it: its CUfunction, threads a program, dynamic shared memory, and the
    parameters Triton appends after the user's pointers (a scratch buffer
    each: bytes a program, alignment)."""

    function: int
    threads: int
    shared: int
    extra: tuple
    scratch: bool = False    # whether any appended buffer has a size
    cubin: bytes = b""       # the compiled image and its entry's name,
    name: str = ""           # for the persistent compile store


#: Span kernels compiled (or fetched from Triton's cache) through
#: Triton's own path by K1's launcher; a kernel restored from the
#: persistent store (:func:`import_cubins`) counts none.
COMPILES = 0


def _compile(source: SpanSource, args, outs) -> _Compiled:
    """Compile (or fetch from Triton's cache) the kernel of ``source``
    for the specialisation these pointers need, through Triton's own
    path (:func:`_warm`), and read what
    a launch needs from the compiled kernel: the parameters its PTX entry
    declares beyond the user's pointers are the scratch buffers its
    metadata sizes (``*_scratch_size``, in the metadata's field order,
    which is the order Triton's launcher passes them in)."""
    global COMPILES
    COMPILES += 1
    k = _warm(source, args, outs)
    meta = k.metadata
    if meta.num_ctas != 1 or meta.launch_cooperative_grid \
            or meta.launch_pdl:
        raise RuntimeError(
            f"span kernel {source.fn_name}: compiled for clusters or a "
            "cooperative/PDL launch, which K1's launcher does not make")
    ptx = k.asm["ptx"]
    entry = ptx[ptx.index(".entry"):]
    n_params = entry[:entry.index(")")].count(".param")
    scratch = [f[:-len("_size")] for f in meta._fields
               if f.endswith("_scratch_size")]
    if n_params - len(args) - len(outs) != len(scratch):
        raise RuntimeError(
            f"span kernel {source.fn_name}: its PTX entry takes {n_params} "
            f"parameters for {len(args) + len(outs)} pointers and the "
            f"scratch buffers {scratch}")
    extra = tuple((getattr(meta, f"{f}_size"), getattr(meta, f"{f}_align"))
                  for f in scratch)
    return _Compiled(function=k.function, threads=32 * meta.num_warps,
                     shared=meta.shared, extra=extra,
                     scratch=any(size for size, _ in extra),
                     cubin=k.asm["cubin"], name=meta.name)


class _Launcher:
    """K1's launch of one :class:`SpanSource`, built at its first launch:
    the outputs' layout in ONE allocation, and the compiled kernel of
    each pointer specialisation met so far (keyed by device and
    :func:`specialisation`; a new one is compiled through Triton's own
    path, as a second kernel).  A launch gathers the pointers, checks
    their specialisation and types in one pass, and makes one C call."""

    def __init__(self, source: SpanSource):
        self.source = source
        self.blob_t = self.lib = self.tail = None
        self.offsets, self.nbytes = output_layout(source)
        self.types = tuple(dt for *_, dt in source.outputs)
        self.shapes = tuple(tuple(shape) for _, _, shape, _ in source.outputs)
        self.one_type = self.types[0] if len(set(self.types)) == 1 else None
        self.in_types: tuple | None = None
        self.kernels: dict = {}

    def outputs(self, device) -> list:
        """The outputs: views into one allocation, each 16-byte aligned."""
        if len(self.shapes) == 1:
            return [torch.empty(self.shapes[0], dtype=self.types[0],
                                device=device)]
        if self.one_type is not None:
            size = torch.empty((), dtype=self.one_type).element_size()
            buf = torch.empty(-(-self.nbytes // size), dtype=self.one_type,
                              device=device)
            return [buf.as_strided(shape, _strides(shape), off // size)
                    for shape, off in zip(self.shapes, self.offsets)]
        buf = torch.empty(self.nbytes, dtype=torch.uint8, device=device)
        return [buf[off:off + math.prod(shape) * torch.empty(
            (), dtype=dt).element_size()].view(dt).view(shape)
            for shape, dt, off in zip(self.shapes, self.types,
                                      self.offsets)]

    def kernel_for(self, args, outs, ptrs, device_index) -> _Compiled:
        """The compiled kernel for these pointers, compiled on a miss."""
        types = tuple(map(_DTYPE, args))
        if self.in_types is None:
            self.in_types = types
        elif types != self.in_types:
            raise ValueError(
                f"span kernel {self.source.fn_name}: inputs of types "
                f"{list(types)}, compiled for {self.in_types}")
        key = (device_index, specialisation(ptrs))
        entry = self.kernels.get(key)
        if entry is None:
            self.add(key, _compile(self.source, args, outs))
            entry = self.kernels[key]
        return entry

    def add(self, key, entry: _Compiled) -> None:
        """Keep ``entry`` as the compiled kernel of ``key``."""
        self.kernels[key] = entry
        n_ptrs = (len(self.source.inputs) + len(self.source.outputs)
                  + bool(self.source.window))   # a rank window's lo
        self.blob_t = ctypes.c_uint64 * (6 + n_ptrs + len(entry.extra))
        self.tail = [0] * len(entry.extra)

    def launch(self, args, outs, device_index) -> None:
        ptrs = [t.data_ptr() for t in args]
        ptrs += [t.data_ptr() for t in outs]
        entry = self.kernel_for(args, outs, ptrs, device_index)
        scratch = []
        if entry.scratch:
            scratch = [torch.empty(self.source.n_programs * size + align,
                                   dtype=torch.uint8, device=outs[0].device)
                       if size else None for size, align in entry.extra]
            ptrs += [0 if t is None else -(-t.data_ptr() // align) * align
                     for t, (_, align) in zip(scratch, entry.extra)]
        else:
            ptrs += self.tail
        blob = self.blob_t(
            entry.function, self.source.n_programs, entry.threads,
            entry.shared, torch._C._cuda_getCurrentRawStream(device_index),
            len(ptrs), *ptrs)
        if self.lib is None:
            self.lib = _LAUNCH_LIB.load()
        err = self.lib.k1_launch(blob)
        if err:
            raise RuntimeError("K1 launch failed: "
                               f"{self.lib.k1_error_string(err).decode()}")


_DTYPE = operator.attrgetter("dtype")


def _strides(shape) -> tuple:
    return tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))


_LAUNCHERS: dict[tuple, _Launcher] = {}


def launcher_key(source: SpanSource) -> tuple:
    """What a :class:`_Launcher` keeps from its source beside the kernel
    text (which ``fn_name`` hashes): the grid, the launch shape and the
    outputs' shapes and types.  Two sources of one text that differ in
    any of these get a launcher each."""
    return (source.fn_name, source.n_programs, source.num_warps,
            source.num_stages, source.outputs)


def export_cubins(kernel_plan) -> dict:
    """What the persistent store keeps of the span kernels of
    ``kernel_plan`` that K1's launcher compiled in this process: per span
    (by index), per pointer specialisation, the cubin, its entry's name
    and the launch metadata."""
    out = {}
    for i, span in enumerate(kernel_plan.spans):
        launcher = _LAUNCHERS.get(launcher_key(span.source))
        if launcher is None:
            continue
        out[i] = {spec: dict(cubin=c.cubin, name=c.name, threads=c.threads,
                             shared=c.shared, extra=c.extra)
                  for (_, spec), c in launcher.kernels.items() if c.cubin}
    return out


def import_cubins(kernel_plan, cubins: dict, device) -> int:
    """Load the stored cubins of ``kernel_plan``'s span kernels for K1's
    launcher on ``device`` (``cuModuleLoadData``, ``csrc/span_launch.cu``),
    so that their launches compile nothing; returns how many failed to
    load (their span kernels then build cold through Triton)."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    lib = _LAUNCH_LIB.load()
    failed = 0
    with torch.cuda.device(index):
        for i, span in enumerate(kernel_plan.spans):
            for spec, meta in cubins.get(i, {}).items():
                fn = ctypes.c_uint64()
                if lib.k1_load(meta["cubin"], meta["name"].encode(),
                               meta["shared"], ctypes.byref(fn)):
                    failed += 1
                    continue
                key = launcher_key(span.source)
                launcher = _LAUNCHERS.get(key)
                if launcher is None:
                    launcher = _LAUNCHERS[key] = _Launcher(span.source)
                extra = tuple(tuple(e) for e in meta["extra"])
                launcher.add((index, spec), _Compiled(
                    function=fn.value, threads=meta["threads"],
                    shared=meta["shared"], extra=extra,
                    scratch=any(size for size, _ in extra),
                    cubin=meta["cubin"], name=meta["name"]))
    return failed


def launch_span(source: SpanSource, stage_io, device: torch.device,
                lo: int = 0) -> list:
    """One launch over every rank's chunks for a whole span (the ranks
    ``lo ..`` of a rank window's kernel); ``stage_io``: ``(windows,
    env_repl)`` per stage.  Returns each stage's dense values (views into
    one allocation)."""
    global LAUNCHES
    key = launcher_key(source)
    launcher = _LAUNCHERS.get(key)
    if launcher is None:
        launcher = _LAUNCHERS[key] = _Launcher(source)
    args = kernel_args(source, stage_io, lo, device)
    outs = launcher.outputs(device)
    current = torch._C._cuda_getDevice()
    if device.index is None or device.index == current:
        launcher.launch(args, outs, current)
    else:
        with torch.cuda.device(device.index):
            launcher.launch(args, outs, device.index)
    LAUNCHES += 1
    return _stage_outputs(source, len(stage_io), outs)


def span_values_plain(plan, program, windows: dict, env_repl: dict,
                      device, window=None) -> dict:
    """The span kernel's function in plain PyTorch: the body vmapped over
    every rank's chunk lanes (a rank ``window``'s; same inputs, same
    output layout)."""
    from repro_torch.core import transform

    run = transform.lane_values if plan.rank == 1 else transform.lane_values2
    return run(plan, program, env_repl, windows, device, window=window)


def span_values_plain_stages(stages, device, window=None) -> list:
    """A span of several stages in plain PyTorch: each stage's lane
    values in order, a forwarded key's window being the dense values the
    latest earlier stage wrote for it (handed over as a tensor).
    ``stages``: objects with ``plan``, ``program``, ``ext_windows``,
    ``env_repl`` and ``forwarded``."""
    handed: dict = {}
    outs = []
    for st in stages:
        windows = dict(st.ext_windows)
        windows.update({k: handed[k] for k in st.forwarded})
        vals = span_values_plain(st.plan, st.program, windows, st.env_repl,
                                 device, window)
        for k, dec in st.plan.vars.items():
            if dec.out_strategy in ("identity", "partial"):
                handed[k] = vals[k]
        outs.append(vals)
    return outs


def _check_device(tensors, device) -> torch.device:
    """``device`` as a ``torch.device``; raises unless every tensor lies
    on it (a CUDA tensor never reaches the plain version): one pass of
    attribute reads."""
    if not isinstance(device, torch.device):
        device = torch.device(device)
    if device.type == "cuda":
        index = device.index
        for t in tensors:
            if not t.is_cuda or (index is not None
                                 and t.get_device() != index):
                raise ValueError(f"span inputs lie on {t.device}, the span "
                                 f"runs on {device}")
        return device
    for t in tensors:
        if t.device.type != device.type:
            raise ValueError(
                f"span inputs lie on {t.device}, the span runs on {device}")
    if device.type != "cpu":
        raise ValueError(f"the span kernel runs on CUDA, not {device}")
    return device


def span_stage_values(stages, source: SpanSource | None, device,
                      window=None) -> list:
    """Dense per-lane values of every stage of a span, as one launch on
    CUDA (or the plain version on the CPU), over the ranks of a rank
    ``window`` ``(lo, block)`` (``None``: every rank); see
    :func:`span_values_plain_stages` for ``stages``."""
    tensors = []
    for st in stages:
        tensors += st.ext_windows.values()
        tensors += st.env_repl.values()
    device = _check_device(tensors, device)
    if device.type == "cpu":
        return span_values_plain_stages(stages, device, window)
    if source is None:
        raise ValueError("no span kernel source for a CUDA span: compile "
                         "with lowering='kernel'")
    block = None if window is None else window[1]
    if (source.window[0] if source.window else None) != block:
        raise ValueError(
            f"span kernel {source.fn_name} was generated for "
            f"{source.window or 'every rank'} and launched on the rank "
            f"window {window}: compile on the mesh it runs on")
    io = [(st.ext_windows, st.env_repl) for st in stages]
    return launch_span(source, io, device,
                       lo=0 if window is None else window[0])
