"""K1 — the span kernel: the loop bodies of a span (one block, or a chain
of exchange-free region stages) on every lane of every rank's chunks, in
ONE Triton launch for Hopper (``sm_90a``).

Replaces ``src/repro/core/pallas_lower.py::execute_span`` (its
``pl.pallas_call``), which ran once per device over that device's slab.

Bound: device-memory bytes.  Each lane loads its window taps and
replicated operands and stores its dense values; the bodies do a few
flops per byte, far below the H100's float32 ridge (67 TFLOP/s over
3.35 TB/s, about 20 flops per byte).  So the design keeps every access
coalesced (lanes of a tile are consecutive iterations, the last nest
axis fastest) and fuses the whole body into one pass: no intermediate
ever leaves registers.  A first version makes no attempt at shared-memory
staging of halo windows: a stencil's neighbouring lanes load overlapping
taps straight from the slab and the overlap is left to L1/L2.

The body is user code, so the kernel is a template plus a generator, as
the Pallas kernel traced the body into its own body:

* :data:`PROLOGUE1` / :data:`PROLOGUE2` (hand-written) decompose the
  program id into (chunk slot, tile) — one slot per (local chunk, rank),
  so all virtual ranks share the launch — and compute every lane's
  iteration, clamped to ``trip - 1`` past the trip count.  The grid
  covers only the slots that hold an iteration (:func:`live_slots`), so
  the chunk plan's padding slots are neither launched nor stored; the
  lanes past the trip in the last slot of an axis compute the clamped
  iteration and are stored, as in the Pallas kernel (no merge reads
  them).  A mask on the trip count there cost ``heat2d`` about 30%
  (PERF.md);
* :class:`_Gen` walks the aten graph of ``vmap(body)``
  (:func:`repro_torch.core.context.trace_body`) and emits one ``tl``
  expression per op: affine loads from the slab windows (row
  ``index - (k0 + halo_base)``) or from replicated arrays, pointwise
  arithmetic, ``sum``/``amax``/``amin`` over a short trailing value axis
  padded to a power of two;
* the epilogue stores the dense values, masked, in the global slab
  layout ``(n_loc, P, c, *value_shape)``.

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
iterator) — and raises ``CompileError`` otherwise.  All stages share one
chunk geometry, so one tile and one grid (checked, not assumed).

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
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import math
import os
from pathlib import Path
from typing import Any

import torch

from repro_torch.core import context as ctx_mod
from repro_torch.core.api import CompileError
from repro_torch.core.nest import (derive_nest_tiles, pow2_at_least,
                                   window_extent)

aten = torch.ops.aten

#: Kernel launches so far (one per span launched on CUDA).
LAUNCHES = 0

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

#: Lane-vector sizes of the second trace: a graph dim whose size differs
#: between the two traces is a lane dim, one that keeps it a value dim.
_LANES_B = (11, 13)

#: Largest tile the template holds in registers: lanes x padded value axis.
_MAX_TILE_ELEMS = 1 << 16

#: Element count from which offsets are computed in 64 bits (a margin
#: below 2^31 for window halos and padded values).
_WIDE_ELEMS = 1 << 29

NUM_WARPS = 4


_TL = {
    torch.float32: "tl.float32", torch.float16: "tl.float16",
    torch.bfloat16: "tl.bfloat16", torch.float64: "tl.float64",
    torch.int32: "tl.int32", torch.int64: "tl.int64",
    torch.int16: "tl.int16", torch.int8: "tl.int8", torch.uint8: "tl.uint8",
    torch.bool: "tl.int1",
}


PROLOGUE1 = """\
    pid = tl.program_id(0){wide}
    slot = pid // {nt}
    tile = pid - slot * {nt}
    lane = tile * {tile} + tl.arange(0, {tile})[:, None]
    it = slot * {c} + lane
    lmask = lane < {c}
    i0 = ({start} + {step} * tl.minimum(it, {tmax})).to(tl.int32)
"""

PROLOGUE2 = """\
    pid = tl.program_id(0){wide}
    tj = pid % {ntj}
    r = pid // {ntj}
    sj = r % {nsj}
    r = r // {nsj}
    ti = r % {nti}
    si = r // {nti}
    f = tl.arange(0, {lanes})[:, None]
    li = ti * {ti} + f // {tj}
    lj = tj * {tj} + f % {tj}
    iti = si * {ci} + li
    itj = sj * {cj} + lj
    lmask = (li < {ci}) & (lj < {cj})
    i0 = ({starti} + {stepi} * tl.minimum(iti, {tmaxi})).to(tl.int32)
    j0 = ({startj} + {stepj} * tl.minimum(itj, {tmaxj})).to(tl.int32)
"""


@dataclasses.dataclass(frozen=True)
class SpanSource:
    """One generated span kernel and how to call it."""

    fn_name: str
    text: str
    inputs: tuple            # ("win" | "repl", stage, key) per pointer arg
    outputs: tuple           # (stage, key, global shape, dtype) per output
    n_programs: int
    flops_per_lane: int      # arithmetic ops per real lane (for the bound)
    forwarded: tuple = ()    # (stage, key): reads served from a register


# ---------------------------------------------------------------------------
# Code generation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Mem:
    """An env buffer, possibly with constant positions selected."""

    key: str
    shape: tuple
    fixed: dict
    remaining: list


@dataclasses.dataclass
class _Val:
    expr: str | None = None
    dtype: Any = None
    lane: bool = False          # varies across lanes
    k: int | None = None        # length of the per-lane value axis
    const: Any = None           # a Python number (inline literal)
    mem: _Mem | None = None
    aff: tuple | None = None    # (axis, a, b): exactly a * iterator + b


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


class _Gen:
    """Walks the aten graphs of a span's stages in order, emitting one
    kernel body line by line; :meth:`stage` starts each stage."""

    def __init__(self, plans):
        plan0 = plans[0]
        self.rank = plan0.rank
        self.lines: list[str] = []
        self.n = 0
        self.flops = 0
        self.kvars: dict[int, tuple[str, str]] = {}
        self.ptrs: dict[tuple, str] = {}
        self.inputs: list = []
        self.fwd_vals: dict[str, tuple[_Val, tuple]] = {}
        self.fwd_reads: list = []
        chs = plan0.chunks_axes
        self.tiles = derive_nest_tiles(tuple(ch.chunk for ch in chs))
        self.block = math.prod(t.tile for t in self.tiles)
        # 64-bit offsets once an input buffer or a dense output could pass
        # 2^31 elements; 32-bit below
        sizes = [math.prod(plan.context.vars[k].shape)
                 for plan in plans for k in plan.context.env_keys]
        sizes += [math.prod(_out_shape(plan, k))
                  for plan in plans for k in plan.written_keys]
        self.wide = max(sizes, default=0) >= _WIDE_ELEMS
        self.loops0 = plan0.nest.axes

    def stage(self, si, plan, trace_a, trace_b, forwarded) -> None:
        """Begin stage ``si``: its graph's values, and the keys whose
        reads come from an earlier span stage's register tile."""
        self.si, self.plan = si, plan
        self.forwarded = frozenset(forwarded)
        self.vals = {}
        self.roles = self._roles(trace_a, trace_b)
        self.constants = ctx_mod.graph_constants(trace_a.graph)
        self.lines.append(f"    # stage {si}: {plan.name}")
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

    # -- lane/value roles from two traces ---------------------------------

    def _roles(self, ta, tb):
        na, nb = list(ta.graph.nodes), list(tb.graph.nodes)
        if len(na) != len(nb) or any(
                a.op != b.op or a.target != b.target for a, b in zip(na, nb)):
            raise CompileError(
                f"span kernel: the body of {self.plan.name!r} traces to "
                "different graphs at different lane counts")
        roles = {}
        for a, b in zip(na, nb):
            va, vb = a.meta.get("val"), b.meta.get("val")
            if not isinstance(va, torch.Tensor):
                continue
            sa, sb = tuple(va.shape), tuple(vb.shape)
            roles[a] = tuple("lane" if x != y else ("v" if x > 1 else "1")
                             for x, y in zip(sa, sb))
        return roles

    def _form(self, node):
        roles = self.roles[node]
        shape = tuple(node.meta["val"].shape)
        vdims = [shape[d] for d, r in enumerate(roles) if r == "v"]
        if len(vdims) > 1:
            raise CompileError(
                f"span kernel: {node.target} in {self.plan.name!r} makes a "
                f"per-lane value of shape {tuple(vdims)}; the template holds "
                "at most one value axis per lane (ROADMAP: K1 tl.dot)")
        return "lane" in roles, (vdims[0] if vdims else None)

    # -- emission helpers ---------------------------------------------------

    def emit(self, expr: str, dtype, lane: bool, k, flops: int = 0) -> _Val:
        name = f"v{self.n}"
        self.n += 1
        self.lines.append(f"    {name} = {expr}")
        self.flops += flops * (k or 1)
        return _Val(name, dtype, lane=lane, k=k)

    def kvar(self, k: int) -> tuple[str, str]:
        """(arange, mask) names of a padded value axis of length k."""
        if k not in self.kvars:
            kp = pow2_at_least(k)
            if kp * self.block > _MAX_TILE_ELEMS:
                raise CompileError(
                    f"span kernel: a per-lane value axis of {k} elements in "
                    f"{self.plan.name!r} does not fit the elementwise "
                    "template's registers (ROADMAP: K1 tl.dot)")
            r, m = f"kr{k}", f"km{k}"
            self.lines.append(f"    {r} = tl.arange(0, {kp})[None, :]")
            self.lines.append(f"    {m} = {r} < {k}")
            self.kvars[k] = (r, m)
        return self.kvars[k]

    def cast(self, v: _Val, dtype) -> str:
        if v.const is not None:
            return _lit(v.const, dtype)
        if v.dtype == dtype:
            return v.expr
        return f"{v.expr}.to({_TL[dtype]})"

    def ptr(self, kind: str, key: str) -> str:
        tag = (self.si, key)
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

    def load(self, mem: _Mem, indices: list) -> _Val:
        if mem.key in self.forwarded:
            return self._forwarded(mem, indices)
        plan = self.plan
        key = mem.key
        dec = plan.vars[key]
        info = plan.context.vars[key]
        shape = mem.shape
        idx_by_dim = {d: (indices[p] if p < len(indices) else None)
                      for p, d in enumerate(mem.remaining)}
        sharded = dec.in_strategy in ("shard", "shard_halo")
        n_sh = (1 if self.rank == 1 else dec.shard_ndim) if sharded else 0
        chs = plan.chunks_axes
        offs, widths = [], []
        for d in range(n_sh):
            halo = dec.window(d)
            slot = "slot" if self.rank == 1 else ("si", "sj")[d]
            offs.append(f"{slot} * {chs[d].chunk} + {halo[0]}")
            widths.append(window_extent(chs[d].chunk, halo))
        exprs, lane, value_k = [], False, None
        for d, size in enumerate(shape):
            if d in mem.fixed:
                exprs.append(str(mem.fixed[d]))
                continue
            ix = idx_by_dim.get(d)
            if ix is None:                       # a whole axis
                if size == 1:
                    exprs.append("0")
                    continue
                if value_k is not None:
                    raise CompileError(
                        f"span kernel: env[{key!r}] read with two whole "
                        f"axes in {plan.name!r}; the template holds one "
                        "value axis per lane (ROADMAP: K1 tl.dot)")
                value_k = size
                exprs.append(self.kvar(size)[0])
                continue
            if not isinstance(ix, torch.fx.Node):
                raise CompileError(
                    f"span kernel: index {ix!r} of env[{key!r}] is not a "
                    "tensor")
            v = self.value(ix)
            if v.dtype is not None and not (v.dtype.is_floating_point
                                            or v.dtype == torch.bool):
                lane |= v.lane
                exprs.append(self._index_expr(
                    v, size, offs[d] if d < n_sh else None,
                    widths[d] if d < n_sh else None))
                continue
            raise CompileError(
                f"span kernel: env[{key!r}] indexed by a {v.dtype} value in "
                f"{plan.name!r}")
        if self.wide:       # offsets past 2^31 elements: 64-bit indices
            exprs = [e if e.lstrip("-").isdigit() else f"({e}).to(tl.int64)"
                     for e in exprs]
        off = self._offset(exprs, shape, n_sh, widths)
        p = self.ptr("win" if sharded else "repl", key)
        if value_k is not None:
            km = self.kvar(value_k)[1]
            return self.emit(f"tl.load({p} + {off}, mask={km}, other=0)",
                             info.dtype, lane, value_k)
        return self.emit(f"tl.load({p} + {off})", info.dtype, lane, None)

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
        fv, bases = self.fwd_vals[key]
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
        r, _ = self.kvar(fv.k)
        return self.emit(f"tl.sum(tl.where({r} == {pos}, {fv.expr}, 0), "
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
    _MATH = {aten.exp.default: "tl.exp", aten.log.default: "tl.log",
             aten.sqrt.default: "tl.sqrt"}
    _REDUCE = {aten.sum.dim_IntList: "sum", aten.sum.default: "sum",
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
                idx = args[2] + m.shape[d] if args[2] < 0 else args[2]
                self.vals[n] = _Val(mem=_Mem(
                    m.key, m.shape, {**m.fixed, d: idx},
                    m.remaining[:args[1]] + m.remaining[args[1] + 1:]))
            else:
                self.vals[n] = self._select(n, self.value(args[0]))
            return
        if t is aten.index.Tensor:
            src = self.vals[args[0]]
            if src.mem is None:
                raise CompileError(
                    f"span kernel: aten.index.Tensor on a computed value in "
                    f"{self.plan.name!r} is not supported")
            self.vals[n] = self.load(src.mem, list(args[1]))
            return
        od = n.meta["val"].dtype
        lane, k = self._form(n)
        if t in self._BIN:
            a, b = self.value(args[0]), self.value(args[1])
            alpha = n.kwargs.get("alpha", 1)
            eb = self.cast(b, od)
            if alpha != 1:
                eb = f"({eb} * {_lit(alpha, od)})"
            v = self.emit(f"({self.cast(a, od)} {self._BIN[t]} {eb})",
                          od, lane, k, 1)
            if not (od.is_floating_point or od == torch.bool):
                v.aff = _affine(self._BIN[t], a, b, alpha)
            self.vals[n] = v
        elif t in self._CMP:
            a, b = self.value(args[0]), self.value(args[1])
            ct = self._result_type([a, b])
            self.vals[n] = self.emit(
                f"({self.cast(a, ct)} {self._CMP[t]} {self.cast(b, ct)})",
                od, lane, k, 1)
        elif t in (aten.maximum.default, aten.minimum.default):
            a, b = self.value(args[0]), self.value(args[1])
            fn = "tl.maximum" if t is aten.maximum.default else "tl.minimum"
            self.vals[n] = self.emit(
                f"{fn}({self.cast(a, od)}, {self.cast(b, od)})", od, lane, k, 1)
        elif t in (aten.where.self, aten.where.ScalarSelf,
                   aten.where.ScalarOther, aten.where.Scalar):
            c, a, b = (self.value(x) for x in args[:3])
            ec = self.cast(c, torch.bool)
            self.vals[n] = self.emit(
                f"tl.where({ec}, {self.cast(a, od)}, {self.cast(b, od)})",
                od, lane, k, 1)
        elif t in (aten.remainder.Scalar, aten.remainder.Tensor) \
                and not od.is_floating_point:
            # Python's modulo (sign of the divisor) from C's remainder
            a, b = self.value(args[0]), self.value(args[1])
            eb = self.cast(b, od)
            r = self.emit(f"({self.cast(a, od)} % {eb})", od, lane, k, 1)
            self.vals[n] = self.emit(
                f"tl.where(({r.expr} != 0) & (({r.expr} < 0) != ({eb} < 0)), "
                f"{r.expr} + {eb}, {r.expr})", od, lane, k, 2)
        elif t is aten.neg.default:
            x = self.value(args[0])
            v = self.emit(f"(-{self.cast(x, od)})", od, lane, k, 1)
            if x.aff is not None:
                v.aff = (x.aff[0], -x.aff[1], -x.aff[2])
            self.vals[n] = v
        elif t is aten.abs.default:
            self.vals[n] = self.emit(
                f"tl.abs({self.cast(self.value(args[0]), od)})", od, lane, k, 1)
        elif t is aten.reciprocal.default:
            self.vals[n] = self.emit(
                f"(1.0 / {self.cast(self.value(args[0]), od)})", od, lane, k, 1)
        elif t in self._MATH:
            self.vals[n] = self._math(self._MATH[t], self.value(args[0]), od,
                                      lane, k)
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
                v = self.emit(self.cast(x, od), od, lane, k)
                if not (od.is_floating_point or od == torch.bool):
                    v.aff = x.aff
                self.vals[n] = v
        elif t in ctx_mod.VIEW_OPS:
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
                kp = pow2_at_least(k)
                self.vals[n] = self.emit(
                    f"tl.full([1, {kp}], {_lit(fill, od)}, {_TL[od]})",
                    od, False, k)
        elif t in self._REDUCE:
            self.vals[n] = self._reduce(n, self._REDUCE[t],
                                        self.value(args[0]), od, lane)
        else:
            raise CompileError(
                f"span kernel: aten op {t} in the body of {self.plan.name!r} "
                "is not supported by the Triton template (supported: "
                "pointwise arithmetic, comparisons, where, exp/log/sqrt/abs, "
                "affine env reads, sum/amax/amin over a trailing axis)")

    def _math(self, fn, x, od, lane, k) -> _Val:
        wd = od if od in (torch.float32, torch.float64) else torch.float32
        e = f"{fn}({self.cast(x, wd)})"
        if wd != od:
            e = f"{e}.to({_TL[od]})"
        return self.emit(e, od, lane, k, 1)

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
        r, _ = self.kvar(k)
        return self.emit(f"tl.sum(tl.where({r} == {idx}, {x.expr}, 0), "
                         "axis=1)[:, None]", x.dtype, x.lane, None)

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
        if x.k is None:     # a lane scalar broadcast along the reduced axis
            size = n.args[0].meta["val"].shape[vdims[0]]
            e = self.cast(x, od)
            e = f"({e} * {size})" if kind == "sum" else e
            return self.emit(e, od, x.lane, None)
        k = x.k
        _, m = self.kvar(k)
        if kind == "sum":
            e = f"tl.sum(tl.where({m}, {self.cast(x, od)}, 0), axis=1)[:, None]"
        else:
            ident = 'float("inf")' if od.is_floating_point else str(
                torch.iinfo(od).max)
            if kind == "max":
                ident = "-" + ident if od.is_floating_point else str(
                    torch.iinfo(od).min)
            e = (f"tl.{kind}(tl.where({m}, {self.cast(x, od)}, {ident}), "
                 "axis=1)[:, None]")
        return self.emit(e, od, x.lane, None, k)

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
        kp = pow2_at_least(vshape[0]) if vshape else 1
        mask = "lmask"
        if vshape:
            r, m = self.kvar(vshape[0])
            mask = f"lmask & {m}"
        e = self.cast(v, dt)
        if v.const is not None:
            e = f"tl.full([{self.block}, {kp}], {e}, {_TL[dt]})"
        elif not v.lane or (vshape and v.k is None):
            # broadcast to the whole tile
            e = f"tl.where({mask}, {e}, {e})"
        dec = self.plan.vars[key]
        if dec.out_strategy in ("identity", "partial"):
            # the tile a later span stage reads in place of this output,
            # and where this stage wrote lane k on each axis (k + base)
            tile = self.emit(e, dt, True, vshape[0] if vshape else None)
            maps = ((dec.write_map,) if self.rank == 1 else dec.write_maps)
            self.fwd_vals[key] = (tile, tuple(m.b for m in maps))
            e = tile.expr
        if self.rank == 1:
            c = self.plan.chunks.chunk
            base = f"(slot * {c} + lane)"
        else:
            ch_i, ch_j = self.plan.chunks_axes
            sj = ch_j.local_chunks * ch_j.num_devices
            base = (f"((si * {ch_i.chunk} + li) * {sj * ch_j.chunk} + "
                    f"sj * {ch_j.chunk} + lj)")
        if vshape:
            self.lines.append(f"    tl.store({out_ptr} + {base} * "
                              f"{vshape[0]} + {r}, {e}, mask={mask})")
        else:
            self.lines.append(f"    tl.store({out_ptr} + {base}, {e}, "
                              "mask=lmask)")


def _prologue(plan, tiles, wide: bool) -> str:
    w = ".to(tl.int64)" if wide else ""
    if plan.rank == 1:
        ch, loop = plan.chunks, plan.loop
        return PROLOGUE1.format(
            wide=w, nt=tiles[0].n_tiles, tile=tiles[0].tile, c=ch.chunk,
            start=loop.start, step=loop.step, tmax=loop.trip_count - 1)
    (ch_i, ch_j), (lp_i, lp_j) = plan.chunks_axes, plan.nest.axes
    return PROLOGUE2.format(
        wide=w, ntj=tiles[1].n_tiles, nti=tiles[0].n_tiles,
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


def _out_shape(plan, key) -> tuple:
    vshape = tuple(plan.context.vars[key].write.value_shape)
    lead = []
    for ch in plan.chunks_axes:
        lead += [ch.local_chunks, ch.num_devices, ch.chunk]
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


def generate(plan, program, device=None) -> SpanSource:
    """The span kernel of one block (a span of one stage)."""
    return generate_span([(plan, program, frozenset())], device)


def generate_span(stages, device=None) -> SpanSource:
    """ONE span kernel for a chain of same-geometry stages, generated
    from their bodies' aten graphs in span order.  ``stages``: ``(plan,
    program, forwarded keys)`` per stage; a forwarded key is read from
    the register tile an earlier stage stored for the same lanes.  Every
    stage's written keys are stored in the global dense layout.
    ``CompileError`` for a body the template cannot express, or a
    forwarded read that does not address the lane's own row."""
    plans = [plan for plan, _, _ in stages]
    if any(ch.slot_map is not None for plan in plans
           for ch in plan.chunks_axes):
        raise CompileError(
            "span kernel: straggler-weighted chunk plans run on the "
            "collective lowering only")
    _check_span_geometry(plans)
    device = torch.device("cpu") if device is None else device
    gen = _Gen(plans)
    outputs = []
    for si, (plan, program, forwarded) in enumerate(stages):
        trace_a, trace_b = _traces(plan, program, device)
        gen.stage(si, plan, trace_a, trace_b, forwarded)
        for node in trace_a.graph.nodes:
            gen.node(node)
        updates = trace_a.updates()
        for key in plan.written_keys:
            gen.store(key, updates[key].value, f"o{si}_{len(outputs)}")
            outputs.append((si, key, _out_shape(plan, key),
                            plan.context.vars[key].write.value_dtype))
    plan0 = plans[0]
    params = [f"p{si}_{i}" for i, (_, si, _) in enumerate(gen.inputs)] + \
        [f"o{si}_{i}" for i, (si, _, _, _) in enumerate(outputs)]
    body = _prologue(plan0, gen.tiles, gen.wide) + "\n".join(gen.lines) + "\n"
    digest = hashlib.sha256(
        (",".join(params) + body).encode()).hexdigest()[:16]
    fn_name = f"span_{digest}"
    names = "+".join(plan.name for plan in plans)
    text = (
        f'"""Span kernel of {names!r}, generated by '
        "repro_torch.kernels.span_kernel\nfrom the bodies' aten graphs; "
        'rebuilt on demand, never edited."""\n'
        "import triton\nimport triton.language as tl\n\n\n"
        f"@triton.jit\ndef {fn_name}({', '.join(params)}):\n{body}")
    n_prog = math.prod(live_slots(plan0)) \
        * math.prod(t.n_tiles for t in gen.tiles)
    return SpanSource(fn_name=fn_name, text=text, inputs=tuple(gen.inputs),
                      outputs=tuple(outputs), n_programs=n_prog,
                      flops_per_lane=gen.flops,
                      forwarded=tuple(dict.fromkeys(gen.fwd_reads)))


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


def launch_span(source: SpanSource, stage_io, device: torch.device) -> list:
    """One launch over every rank's chunks for a whole span;
    ``stage_io``: ``(windows, env_repl)`` per stage.  Returns each
    stage's dense values."""
    global LAUNCHES
    fn = _kernel(source)
    args = [stage_io[si][0 if kind == "win" else 1][key].contiguous()
            for kind, si, key in source.inputs]
    outs = [{} for _ in stage_io]
    flat = []
    for si, key, shape, dtype in source.outputs:
        outs[si][key] = torch.empty(shape, dtype=dtype, device=device)
        flat.append(outs[si][key])
    fn[(source.n_programs,)](*args, *flat, num_warps=NUM_WARPS)
    LAUNCHES += 1
    return outs


def span_values_plain(plan, program, windows: dict, env_repl: dict,
                      device) -> dict:
    """The span kernel's function in plain PyTorch: the body vmapped over
    every rank's chunk lanes (same inputs, same output layout)."""
    from repro_torch.core import transform

    run = transform.lane_values if plan.rank == 1 else transform.lane_values2
    return run(plan, program, env_repl, windows, device)


def span_values_plain_stages(stages, device) -> list:
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
                                 device)
        for k, dec in st.plan.vars.items():
            if dec.out_strategy in ("identity", "partial"):
                handed[k] = vals[k]
        outs.append(vals)
    return outs


def _check_device(tensors, device) -> torch.device:
    device = torch.device(device)
    for t in tensors:
        if t.device.type != device.type or (
                device.index is not None and t.device.index != device.index):
            raise ValueError(
                f"span inputs lie on {t.device}, the span runs on {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the span kernel runs on CUDA, not {device}")
    return device


def span_stage_values(stages, source: SpanSource | None, device) -> list:
    """Dense per-lane values of every stage of a span, as one launch on
    CUDA (or the plain version on the CPU); see
    :func:`span_values_plain_stages` for ``stages``."""
    device = _check_device([t for st in stages for t in (
        *st.ext_windows.values(), *st.env_repl.values())], device)
    if device.type == "cpu":
        return span_values_plain_stages(stages, device)
    if source is None:
        raise ValueError("no span kernel source for a CUDA span: compile "
                         "with lowering='kernel'")
    return launch_span(source, [(st.ext_windows, st.env_repl)
                                for st in stages], device)
