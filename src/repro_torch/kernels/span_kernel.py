"""K1 — the span kernel: one block's loop body on every lane of every
rank's chunks, in ONE Triton launch for Hopper (``sm_90a``).

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

An op outside the template raises ``CompileError`` naming it, when the
program compiles.  The source is written to ``build/span_kernels/`` and
imported from there (``@triton.jit`` reads its source from disk); Triton
caches its builds under ``build/triton/``.  Triton is imported only
when a kernel launches, so this module imports on machines without it.

:func:`span_values` is the wrapper: CPU tensors take
:func:`span_values_plain` (the same function in plain PyTorch — the body
vmapped over lanes); CUDA tensors launch the kernel or raise.
:data:`LAUNCHES` counts launches.
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

#: Kernel launches so far (one per :func:`span_values` call on CUDA).
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
    inputs: tuple            # ("win" | "repl", key) per pointer argument
    outputs: tuple           # (key, global shape, dtype) per output
    n_programs: int
    flops_per_lane: int      # arithmetic ops per real lane (for the bound)


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


class _Gen:
    """Walks the aten graph, emitting the kernel body line by line."""

    def __init__(self, plan, trace_a, trace_b):
        self.plan = plan
        self.rank = plan.rank
        self.lines: list[str] = []
        self.vals: dict = {}
        self.n = 0
        self.flops = 0
        self.kvars: dict[int, tuple[str, str]] = {}
        self.ptrs: dict[str, str] = {}
        self.inputs: list = []
        self.roles = self._roles(trace_a, trace_b)
        self.constants = ctx_mod.graph_constants(trace_a.graph)
        chs = plan.chunks_axes
        self.tiles = derive_nest_tiles(tuple(ch.chunk for ch in chs))
        self.block = math.prod(t.tile for t in self.tiles)
        # 64-bit offsets once an input buffer or a dense output could pass
        # 2^31 elements; 32-bit below
        sizes = [math.prod(plan.context.vars[k].shape)
                 for k in plan.context.env_keys]
        sizes += [math.prod(_out_shape(plan, k)) for k in plan.written_keys]
        self.wide = max(sizes, default=0) >= _WIDE_ELEMS
        for it, name in zip(trace_a.iter_nodes, ("i0", "j0")):
            self.vals[it] = _Val(name, torch.int32, lane=True)
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
        if key not in self.ptrs:
            self.ptrs[key] = f"p_{len(self.inputs)}"
            self.inputs.append((kind, key))
        return self.ptrs[key]

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
            self.vals[n] = self.emit(f"({self.cast(a, od)} {self._BIN[t]} {eb})",
                                     od, lane, k, 1)
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
            self.vals[n] = self.emit(f"(-{self.cast(self.value(args[0]), od)})",
                                     od, lane, k, 1)
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
                self.vals[n] = self.emit(self.cast(x, od), od, lane, k)
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


def generate(plan, program, device=None) -> SpanSource:
    """The span kernel of one block, generated from its body's aten graph
    (``CompileError`` for a body the template cannot express)."""
    if any(ch.slot_map is not None for ch in plan.chunks_axes):
        raise CompileError(
            "span kernel: straggler-weighted chunk plans run on the "
            "collective lowering only")
    device = torch.device("cpu") if device is None else device
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
    gen = _Gen(plan, trace_a, trace_b)
    for node in trace_a.graph.nodes:
        gen.node(node)
    updates = trace_a.updates()
    outputs = []
    for oi, key in enumerate(plan.written_keys):
        gen.store(key, updates[key].value, f"o_{oi}")
        outputs.append((key, _out_shape(plan, key),
                        plan.context.vars[key].write.value_dtype))
    params = [f"p_{i}" for i in range(len(gen.inputs))] + \
        [f"o_{i}" for i in range(len(outputs))]
    body = _prologue(plan, gen.tiles, gen.wide) + "\n".join(gen.lines) + "\n"
    digest = hashlib.sha256(
        (",".join(params) + body).encode()).hexdigest()[:16]
    fn_name = f"span_{digest}"
    text = (
        f'"""Span kernel of block {plan.name!r}, generated by '
        "repro_torch.kernels.span_kernel\nfrom the body's aten graph; "
        'rebuilt on demand, never edited."""\n'
        "import triton\nimport triton.language as tl\n\n\n"
        f"@triton.jit\ndef {fn_name}({', '.join(params)}):\n{body}")
    n_prog = math.prod(live_slots(plan)) \
        * math.prod(t.n_tiles for t in gen.tiles)
    return SpanSource(fn_name=fn_name, text=text, inputs=tuple(gen.inputs),
                      outputs=tuple(outputs), n_programs=n_prog,
                      flops_per_lane=gen.flops)


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


def launch(source: SpanSource, windows: dict, env_repl: dict,
           device: torch.device) -> dict:
    """One launch over every rank's chunks; returns the dense values."""
    global LAUNCHES
    fn = _kernel(source)
    args = [(windows if kind == "win" else env_repl)[key].contiguous()
            for kind, key in source.inputs]
    outs = {key: torch.empty(shape, dtype=dtype, device=device)
            for key, shape, dtype in source.outputs}
    fn[(source.n_programs,)](*args, *outs.values(),
                             num_warps=NUM_WARPS)
    LAUNCHES += 1
    return outs


def span_values_plain(plan, program, windows: dict, env_repl: dict,
                      device) -> dict:
    """The span kernel's function in plain PyTorch: the body vmapped over
    every rank's chunk lanes (same inputs, same output layout)."""
    from repro_torch.core import transform

    run = transform.lane_values if plan.rank == 1 else transform.lane_values2
    return run(plan, program, env_repl, windows, device)


def span_values(plan, program, windows: dict, env_repl: dict,
                source: SpanSource | None, device) -> dict:
    """Dense per-lane values of one span.  Tensors on the CPU take the
    plain version; on CUDA the kernel launches, and anything that keeps
    it from launching raises."""
    device = torch.device(device)
    for t in (*windows.values(), *env_repl.values()):
        if t.device.type != device.type or (
                device.index is not None and t.device.index != device.index):
            raise ValueError(
                f"span inputs lie on {t.device}, the span runs on {device}")
    if device.type == "cpu":
        return span_values_plain(plan, program, windows, env_repl, device)
    if device.type != "cuda":
        raise ValueError(f"the span kernel runs on CUDA, not {device}")
    if source is None:
        raise ValueError("no span kernel source for a CUDA span: compile "
                         "with lowering='kernel'")
    return launch(source, windows, env_repl, device)
