"""Context Analysis (paper §3.1.1) over the aten graph of the body.

OMP2MPI classifies every shared variable of an OpenMP block as IN, OUT
or INOUT and works out *where* the parallel iterator appears in each
array access.  The JAX reference walks the body's jaxpr; a PyTorch body
cannot be traced with a scalar iterator (``env["a"][i]`` with a 0-d
index tensor calls ``.item()``), so the port traces
``torch.func.vmap(body)`` over a *lane vector* of iterations with
``make_fx`` on fake tensors and walks the resulting aten graph:

* reads are recovered from how each ``env`` buffer's placeholder is
  consumed — ``aten.index.Tensor`` (after any ``aten.select.int`` with
  constant positions) whose leading index is an *affine* function of the
  lane iterators is a sliced read (``x[a*i+b]``); any other use makes it
  a whole-array read;
* writes are the declared :class:`~repro_torch.core.pragma.At` / ``Put``
  / ``Red`` updates; ``At`` indices are checked for affinity by symbolic
  affine propagation through the graph (add/sub/mul/neg/copy/view chains
  seeded at the lane-iterator placeholders).

The rules mirror the reference access by access: a unit slice with an
affine start on the leading axis and constant (or whole-axis) trailing
axes is SLICED, several such maps STENCIL, anything else WHOLE; a
constant access with a negative position is the reference's constant
``dynamic_slice`` (SLICED), one with non-negative positions its static
``slice`` (WHOLE).

The same graph (:class:`BodyTrace`) is the input of the span kernel's
code generator (:mod:`repro_torch.kernels.span_kernel`).
"""
from __future__ import annotations

import dataclasses
import enum
import numbers
from typing import Any, Mapping

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.core import pragma
from repro_torch.core.loop import LoopInfo, LoopNotCanonical
from repro_torch.core.nest import LoopNest, NestAffine

aten = torch.ops.aten


# ---------------------------------------------------------------------------
# Affine expressions over the loop iterator
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Affine:
    """``a * i + b`` with static integer coefficients."""

    a: int
    b: int

    def __add__(self, other: "Affine") -> "Affine":
        return Affine(self.a + other.a, self.b + other.b)

    def __sub__(self, other: "Affine") -> "Affine":
        return Affine(self.a - other.a, self.b - other.b)

    def scale(self, k: int) -> "Affine":
        return Affine(self.a * k, self.b * k)

    @property
    def is_const(self) -> bool:
        return self.a == 0

    def __repr__(self) -> str:
        if self.a == 0:
            return str(self.b)
        s = "i" if self.a == 1 else f"{self.a}*i"
        return s if self.b == 0 else f"{s}{self.b:+d}"


# ---------------------------------------------------------------------------
# Environment specs (the port's ShapeDtypeStruct)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    shape: tuple[int, ...]
    dtype: torch.dtype


_PY_DEFAULTS = {bool: torch.bool, int: torch.int32, float: torch.float32}
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def spec_of(x: Any) -> TensorSpec:
    """Shape/dtype of an env value without touching its data.  Non-tensor
    values type as JAX would (32-bit defaults)."""
    if isinstance(x, TensorSpec):
        return x
    if isinstance(x, torch.Tensor):
        return TensorSpec(tuple(x.shape), x.dtype)
    if isinstance(x, (bool, int, float)):
        return TensorSpec((), _PY_DEFAULTS[type(x)])
    arr = np.asarray(x)
    dt = torch.from_numpy(np.zeros((), arr.dtype)).dtype
    return TensorSpec(tuple(arr.shape), _NARROW.get(dt, dt))


# ---------------------------------------------------------------------------
# Tracing the vmapped body
# ---------------------------------------------------------------------------


def _as_tensor_like(v, like: torch.Tensor):
    """Python numbers an update carries (``omp.at(3, v)``) become tensors
    so vmap can return them; ints as int32, floats as float32."""
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, numbers.Number):
        dt = _PY_DEFAULTS.get(type(v), torch.float32)
        return torch.tensor(v, dtype=dt, device=like.device)
    return v


def lane_body(program, rank: int):
    """The body as a function of lane-level iterators, with Python-number
    update leaves turned into tensors and the return type checked."""
    def fn(*args):
        its, env = args[:rank], args[rank]
        out = program.body(*its, env)
        if not isinstance(out, dict):
            raise LoopNotCanonical("body must return a dict of omp updates")
        fixed = {}
        for key, upd in out.items():
            if isinstance(upd, pragma.At):
                idx = upd.idx
                if isinstance(idx, tuple):
                    idx = tuple(_as_tensor_like(e, its[0]) for e in idx)
                else:
                    idx = _as_tensor_like(idx, its[0])
                fixed[key] = pragma.At(idx, _as_tensor_like(upd.value, its[0]))
            elif isinstance(upd, pragma.Put):
                fixed[key] = pragma.Put(_as_tensor_like(upd.value, its[0]))
            elif isinstance(upd, pragma.Red):
                fixed[key] = pragma.Red(_as_tensor_like(upd.value, its[0]))
            else:
                fixed[key] = upd
        return fixed
    return fn


class _ZeroDimRoll(torch.overrides.TorchFunctionMode):
    """``torch.roll`` of a 0-d value is that value, as it is outside vmap
    and as ``jnp.roll`` of a 0-d array is; vmap's batching rule for it
    rolls the value across the batch (the lanes) instead.

    A gather through a per-lane index vector (an integer tensor index of
    one or more dims) indexes as ``jnp`` does: a negative index wraps
    once, then every index clamps into bounds (torch would raise).  A
    lane's scalar index is left alone: its reads are classified, and
    clamped where sliced, by Context Analysis (:class:`ClampedArray`).

    A sort (or argsort) is stable, as ``jnp.sort``/``jnp.argsort`` are:
    equal values keep their order, so the indices equal the reference's
    (torch's default sort may reorder them)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.roll, torch.Tensor.roll) and args \
                and isinstance(args[0], torch.Tensor) and args[0].dim() == 0:
            return args[0]
        if func in _SORTS and args:
            kw = dict(zip(("dim", "descending"), args[1:]))
            kw.update(kwargs or {})
            kw["stable"] = True
            return func(args[0], **kw)
        if func is torch.Tensor.__getitem__ and len(args) == 2:
            args = (args[0], _clamped_index(args[0], args[1]))
        return func(*args, **(kwargs or {}))


_SORTS = (torch.sort, torch.Tensor.sort, torch.argsort, torch.Tensor.argsort)


def _clamped_index(x: torch.Tensor, idx):
    """``idx`` with each integer index vector wrapped once and clamped
    into its axis of ``x`` (indices with ``None``/``...`` pass as they
    are)."""
    tup = idx if isinstance(idx, tuple) else (idx,)
    if len(tup) > x.dim() or any(e is None or e is Ellipsis for e in tup):
        return idx
    out, hit = [], False
    for d, e in enumerate(tup):
        if (isinstance(e, torch.Tensor) and e.dim() >= 1
                and not e.dtype.is_floating_point and e.dtype != torch.bool):
            n = x.shape[d]
            e = torch.clamp(torch.where(e < 0, e + n, e), 0, n - 1)
            hit = True
        out.append(e)
    if not hit:
        return idx
    return tuple(out) if isinstance(idx, tuple) else out[0]


def vmap_lanes(fn, rank: int, ivecs, env):
    """Evaluate ``fn(i[, j], env)`` on every lane: one vmap over ``i``
    for rank 1, the cross product (i outer, j inner) for rank 2; a lane
    scalar's roll is the identity (:class:`_ZeroDimRoll`)."""
    from torch.func import vmap

    with _ZeroDimRoll():
        if rank == 1:
            return vmap(lambda i: fn(i, env))(ivecs[0])
        return vmap(lambda i: vmap(lambda j: fn(i, j, env))(ivecs[1]))(
            ivecs[0])


@dataclasses.dataclass
class BodyTrace:
    """The aten graph of ``vmap(body)`` over lane vectors of sizes
    ``lanes``, traced on fake tensors (no data is touched)."""

    graph: torch.fx.Graph
    lanes: tuple[int, ...]
    iter_nodes: tuple            # lane-iterator placeholders (i[, j])
    env_nodes: dict              # env key -> placeholder node
    out_tree: Any                # pytree spec of the update dict
    out_leaves: list             # graph nodes of the flattened updates

    def updates(self) -> dict:
        """The update dict with graph nodes as leaves."""
        return pytree.tree_unflatten(self.out_leaves, self.out_tree)


def trace_body(program, env_specs: Mapping[str, TensorSpec], rank: int,
               lanes: tuple[int, ...], device) -> BodyTrace:
    keys = list(env_specs)
    fn = lane_body(program, rank)
    holder: dict[str, Any] = {}

    def traced(*args):
        ivecs, env = args[:rank], dict(zip(keys, args[rank:]))
        out = vmap_lanes(fn, rank, ivecs, env)
        leaves, spec = pytree.tree_flatten(out)
        holder["spec"] = spec
        return leaves

    with FakeTensorMode():
        args = [torch.empty(n, dtype=torch.int32, device=device)
                for n in lanes]
        args += [torch.empty(env_specs[k].shape, dtype=env_specs[k].dtype,
                             device=device) for k in keys]
    gm = make_fx(traced, tracing_mode="fake")(*args)
    graph = gm.graph
    graph.eliminate_dead_code()
    placeholders = [n for n in graph.nodes if n.op == "placeholder"]
    (out_node,) = [n for n in graph.nodes if n.op == "output"]
    leaves = list(out_node.args[0])
    return BodyTrace(
        graph=graph, lanes=tuple(lanes),
        iter_nodes=tuple(placeholders[:rank]),
        env_nodes=dict(zip(keys, placeholders[rank:])),
        out_tree=holder["spec"], out_leaves=leaves)


# ---------------------------------------------------------------------------
# Affine propagation over the aten graph
# ---------------------------------------------------------------------------

#: aten ops that pass a lane value through unchanged (layout only).
VIEW_OPS = frozenset({
    aten.view.default, aten._unsafe_view.default, aten.reshape.default,
    aten.unsqueeze.default, aten.squeeze.dim, aten.squeeze.dims,
    aten.squeeze.default, aten.expand.default, aten.clone.default,
    aten.alias.default, aten.detach.default, aten.lift_fresh_copy.default,
    aten.permute.default, aten.t.default, aten.transpose.int,
    aten._to_copy.default,
})


def const_value(a) -> Any:
    """A Python number the graph carries inline, or None."""
    if isinstance(a, bool):
        return None
    if isinstance(a, numbers.Number):
        return a
    return None


def _int_of(v) -> int | None:
    if v is None:
        return None
    if isinstance(v, float):
        return int(v) if v.is_integer() else None
    return int(v)


class AffineEnv:
    """Symbolic affine propagation over graph nodes.

    Works over :class:`Affine` (one iterator) or
    :class:`~repro_torch.core.nest.NestAffine` (a nest); ``seeds`` maps
    iterator placeholders to their affine seeds, ``const`` builds a
    constant of the same representation.
    """

    def __init__(self, seeds: Mapping[Any, Any], const=None) -> None:
        self._map: dict[Any, Any] = dict(seeds)
        self._const = const or (lambda v: Affine(0, v))

    def lookup(self, atom):
        if isinstance(atom, torch.fx.Node):
            return self._map.get(atom)
        v = _int_of(const_value(atom))
        return None if v is None else self._const(v)

    def process(self, node, constants: Mapping[str, Any]) -> None:
        if node.op == "get_attr":
            c = constants.get(node.target)
            if c is not None and c.ndim == 0 and not c.is_floating_point():
                self._map[node] = self._const(int(c))
            return
        if node.op != "call_function":
            return
        t, args = node.target, node.args
        ins = [self.lookup(a) for a in args]
        alpha = _int_of(const_value(node.kwargs.get("alpha", 1)))
        res = None
        if t in (aten.add.Tensor, aten.add.Scalar) and None not in ins[:2] \
                and alpha is not None:
            res = ins[0] + ins[1].scale(alpha)
        elif t in (aten.sub.Tensor, aten.sub.Scalar) and None not in ins[:2] \
                and alpha is not None:
            res = ins[0] - ins[1].scale(alpha)
        elif t in (aten.mul.Tensor, aten.mul.Scalar) and None not in ins[:2]:
            if ins[0].is_const:
                res = ins[1].scale(ins[0].b)
            elif ins[1].is_const:
                res = ins[0].scale(ins[1].b)
        elif t is aten.neg.default and ins[0] is not None:
            res = ins[0].scale(-1)
        elif t in VIEW_OPS and args:
            if isinstance(args[0], torch.fx.Node):
                res = ins[0]
            elif t is aten._to_copy.default:     # an inline literal
                res = ins[0]
        elif t in (aten.full.default, aten.scalar_tensor.default):
            res = self.lookup(args[1] if t is aten.full.default else args[0])
        elif t is aten.maximum.default and None not in ins[:2]:
            # clamp(i, 0) pattern with a non-negative iteration space
            if ins[0].is_const and ins[0].b == 0:
                res = ins[1]
            elif ins[1].is_const and ins[1].b == 0:
                res = ins[0]
        if res is not None:
            self._map[node] = res


def graph_constants(graph: torch.fx.Graph) -> dict:
    owner = graph.owning_module
    out = {}
    for n in graph.nodes:
        if n.op == "get_attr":
            out[n.target] = getattr(owner, n.target)
    return out


# ---------------------------------------------------------------------------
# Env accesses: select chains + index.Tensor, in the reference's terms
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Access:
    """One read of an env buffer in the reference's dynamic_slice terms:
    per buffer axis a start (affine or None) and a slice size.
    ``static`` marks an all-constant non-negative access (the
    reference's static ``slice``: a whole-array use)."""

    starts: tuple
    sizes: tuple
    static: bool = False


def env_accesses(placeholder, shape, aff: AffineEnv, constants):
    """Every access of one env buffer; ``None`` in the list marks a
    whole-array use (any consumer other than a select/index chain)."""
    out: list[Access | None] = []

    def walk(node, fixed: dict, remaining: list):
        for user in node.users:
            t = user.target
            if t is aten.select.int and user.args[0] is node:
                dim, idx = user.args[1], user.args[2]
                orig = remaining[dim]
                if idx < 0:
                    idx += shape[orig]
                walk(user, {**fixed, orig: (idx, user.args[2] < 0)},
                     remaining[:dim] + remaining[dim + 1:])
            elif t is aten.index.Tensor and user.args[0] is node:
                starts, sizes = [None] * len(shape), [1] * len(shape)
                for d, (v, _) in fixed.items():
                    starts[d] = aff.lookup(v)
                indices = list(user.args[1])
                for pos, d in enumerate(remaining):
                    ix = indices[pos] if pos < len(indices) else None
                    if ix is None:
                        starts[d], sizes[d] = aff.lookup(0), shape[d]
                    elif isinstance(ix, torch.fx.Node):
                        val = ix.meta.get("val")
                        if val is not None and val.dtype == torch.bool:
                            starts[d] = None
                        else:
                            starts[d] = aff.lookup(ix)
                    else:
                        starts[d] = None
                out.append(Access(tuple(starts), tuple(sizes)))
            elif not fixed:
                out.append(None)
            else:
                starts = [aff.lookup(0)] * len(shape)
                sizes = list(shape)
                for d, (v, _) in fixed.items():
                    starts[d], sizes[d] = aff.lookup(v), 1
                negative = any(neg for _, neg in fixed.values())
                out.append(Access(tuple(starts), tuple(sizes),
                                  static=not negative))

    walk(placeholder, {}, list(range(len(shape))))
    return out


# ---------------------------------------------------------------------------
# Classification results
# ---------------------------------------------------------------------------


class ReadKind(enum.Enum):
    NONE = "none"
    SLICED = "sliced"    # every use is x[a*i+b] on the leading dim
    STENCIL = "stencil"  # several unit-stride maps x[i+b0..i+bk] (halo)
    WHOLE = "whole"


class WriteKind(enum.Enum):
    NONE = "none"
    AT = "at"
    PUT = "put"
    RED = "red"


class VarClass(enum.Enum):
    UNUSED = "unused"
    IN = "in"
    OUT = "out"
    INOUT = "inout"
    REDUCTION = "reduction"


@dataclasses.dataclass
class ReadInfo:
    kind: ReadKind
    affine: Affine | None = None          # leading-dim index map for SLICED
    affines: list | None = None           # all maps for STENCIL reads
    slice_ndim: int = 0                   # rank-2: sliced leading axes
    accesses: tuple | None = None         # rank-2: distinct affine tuples


@dataclasses.dataclass
class WriteInfo:
    kind: WriteKind
    affine: Affine | None = None          # index map for AT (None: non-affine)
    value_shape: tuple[int, ...] = ()
    value_dtype: Any = None
    reduction_op: str | None = None
    affines2: tuple | None = None         # rank-2: per-axis At maps


@dataclasses.dataclass
class VarInfo:
    name: str
    read: ReadInfo
    write: WriteInfo
    klass: VarClass
    shape: tuple[int, ...] = ()
    dtype: Any = None


@dataclasses.dataclass
class ContextInfo:
    """Output of the Context Analysis stage for one parallel block."""

    vars: dict[str, VarInfo]
    env_keys: list[str]
    update_keys: list[str]
    trace: BodyTrace | None = dataclasses.field(default=None, repr=False,
                                                compare=False)


# ---------------------------------------------------------------------------
# Analysis driver
# ---------------------------------------------------------------------------

#: Lane-vector sizes of the analysis trace (any sizes > 1 do).
ANALYSIS_LANES = (5, 7)


def _access_prefix(starts, sizes, shape) -> int:
    """Largest sliced prefix r in {1, 2} an access supports: axes d < r
    are unit slices with affine starts; axes d >= r are whole-axis slices
    (const-0 start) or const unit slices.  0 = neither."""
    def suffix_ok(d0: int) -> bool:
        for d in range(d0, len(shape)):
            a = starts[d]
            if a is None:
                return False
            if sizes[d] == shape[d] and a.is_const and a.b == 0:
                continue
            if sizes[d] == 1 and a.is_const:
                continue
            return False
        return True

    for r in (2, 1):
        if len(shape) < r or len(sizes) != len(shape):
            continue
        if all(sizes[d] == 1 and starts[d] is not None for d in range(r)) \
                and suffix_ok(r):
            return r
    return 0


def _writes(program, trace: BodyTrace, aff: AffineEnv, rank: int):
    updates = trace.updates()
    writes: dict[str, WriteInfo] = {}

    def vinfo(leaf):
        val = leaf.meta["val"]
        return tuple(val.shape[rank:]), val.dtype

    # the reference's dict flattening visits update keys in sorted order
    for key in sorted(updates):
        upd = updates[key]
        if isinstance(upd, pragma.At):
            vshape, vdtype = vinfo(upd.value)
            if rank == 1:
                if isinstance(upd.idx, tuple):
                    raise LoopNotCanonical(
                        f"{key!r}: a rank-1 write takes omp.at(i, v) with "
                        "a single index")
                writes[key] = WriteInfo(WriteKind.AT,
                                        affine=aff.lookup(upd.idx),
                                        value_shape=vshape, value_dtype=vdtype)
            else:
                idx = upd.idx if isinstance(upd.idx, tuple) else (upd.idx,)
                if len(idx) != 2:
                    raise LoopNotCanonical(
                        f"{key!r}: a collapse=2 write needs omp.at((i, j), v) "
                        f"with a 2-tuple index, got {len(idx)} indices"
                    )
                writes[key] = WriteInfo(
                    WriteKind.AT, affines2=tuple(aff.lookup(p) for p in idx),
                    value_shape=vshape, value_dtype=vdtype)
        elif isinstance(upd, pragma.Put):
            if rank == 2:
                raise LoopNotCanonical(
                    f"{key!r}: omp.put is not supported inside a collapse=2 "
                    "nest (paper §3.1.3: the block is kept as OpenMP)"
                )
            vshape, vdtype = vinfo(upd.value)
            writes[key] = WriteInfo(WriteKind.PUT, value_shape=vshape,
                                    value_dtype=vdtype)
        elif isinstance(upd, pragma.Red):
            if key not in program.reduction:
                raise LoopNotCanonical(
                    f"omp.red() for {key!r} without a reduction clause "
                    "(paper: reductions must be declared with reduction(op: var))"
                )
            vshape, vdtype = vinfo(upd.value)
            writes[key] = WriteInfo(WriteKind.RED, value_shape=vshape,
                                    value_dtype=vdtype,
                                    reduction_op=program.reduction[key])
        else:
            what = ("omp.at/omp.put/omp.red" if rank == 1
                    else "omp.at/omp.red in a collapse=2 nest")
            raise LoopNotCanonical(
                f"update for {key!r} must be {what}, got "
                f"{type(upd).__name__}"
            )

    for key in program.reduction:
        if key in writes and writes[key].kind != WriteKind.RED:
            raise LoopNotCanonical(
                f"{key!r} is declared as a reduction but written with "
                f"{writes[key].kind.value}"
            )
    return writes


def _read_info1(accesses) -> ReadInfo:
    """Rank-1 read classification from the list of accesses."""
    if not accesses:
        return ReadInfo(ReadKind.NONE)
    affs = []
    for acc in accesses:
        if acc is None or acc.static:
            return ReadInfo(ReadKind.WHOLE)
        lead = acc.starts[0] if acc.starts else None
        rest_ok = all(a is not None and a.is_const for a in acc.starts[1:])
        if lead is None or not acc.sizes or acc.sizes[0] != 1 or not rest_ok:
            return ReadInfo(ReadKind.WHOLE)
        affs.append(lead)
    if len({(a.a, a.b) for a in affs}) == 1:
        return ReadInfo(ReadKind.SLICED, affs[0])
    if all(a.a == affs[0].a for a in affs):
        uniq = sorted({(a.a, a.b) for a in affs}, key=lambda t: t[1])
        return ReadInfo(ReadKind.STENCIL, affs[0],
                        [Affine(a, b) for a, b in uniq])
    return ReadInfo(ReadKind.WHOLE)


def _read_info2(accesses, shape) -> ReadInfo:
    """Rank-2 read classification (``_access_prefix`` per access)."""
    if not accesses:
        return ReadInfo(ReadKind.NONE)
    uses = []
    for acc in accesses:
        if acc is None or acc.static:
            return ReadInfo(ReadKind.WHOLE)
        r = _access_prefix(acc.starts, acc.sizes, tuple(shape))
        if not r:
            return ReadInfo(ReadKind.WHOLE)
        uses.append((acc.starts[:r], r))
    r = min(u[1] for u in uses)
    maps: list[tuple] = []
    seen: set = set()
    for starts, _ in uses:
        if any(a is None or not a.is_const for a in starts[r:]):
            return ReadInfo(ReadKind.WHOLE)
        t = starts[:r]
        sig = tuple((a.coeffs, a.b) for a in t)
        if sig not in seen:
            seen.add(sig)
            maps.append(t)
    kind = ReadKind.SLICED if len(maps) == 1 else ReadKind.STENCIL
    return ReadInfo(kind, slice_ndim=r, accesses=tuple(maps))


def affine_env(trace: BodyTrace, rank: int) -> AffineEnv:
    """Affine values of every graph node of ``trace``."""
    if rank == 1:
        aff = AffineEnv({trace.iter_nodes[0]: Affine(1, 0)})
    else:
        aff = AffineEnv(
            {trace.iter_nodes[0]: NestAffine((1, 0), 0),
             trace.iter_nodes[1]: NestAffine((0, 1), 0)},
            const=lambda v: NestAffine((0, 0), v))
    constants = graph_constants(trace.graph)
    for node in trace.graph.nodes:
        aff.process(node, constants)
    return aff


def analyze_context(program: pragma.ParallelFor, env: Mapping[str, Any],
                    loop: LoopInfo | LoopNest, device=None) -> ContextInfo:
    """Run the Context Analysis stage: trace the vmapped body once on
    fake tensors, then classify every env buffer from the aten graph."""
    rank = loop.rank if isinstance(loop, LoopNest) else 1
    env_specs = {k: spec_of(v) for k, v in env.items()}
    if device is None:
        device = next((v.device for v in env.values()
                       if isinstance(v, torch.Tensor)), torch.device("cpu"))
    trace = trace_body(program, env_specs, rank, ANALYSIS_LANES[:rank],
                       device)
    aff = affine_env(trace, rank)
    constants = graph_constants(trace.graph)
    writes = _writes(program, trace, aff, rank)

    env_keys = list(env_specs)
    infos: dict[str, VarInfo] = {}
    for key in env_keys + [k for k in writes if k not in env_specs]:
        if key in env_specs:
            shape, dtype = env_specs[key].shape, env_specs[key].dtype
            accesses = env_accesses(trace.env_nodes[key], shape, aff,
                                    constants)
            read = (_read_info1(accesses) if rank == 1
                    else _read_info2(accesses, shape))
        else:
            # reduction outputs may be fresh (not pre-existing in env)
            shape, dtype = writes[key].value_shape, writes[key].value_dtype
            read = ReadInfo(ReadKind.NONE)
        write = writes.get(key, WriteInfo(WriteKind.NONE))
        if write.kind == WriteKind.RED:
            klass = VarClass.REDUCTION
        elif write.kind == WriteKind.NONE:
            klass = VarClass.IN if read.kind != ReadKind.NONE else VarClass.UNUSED
        elif read.kind == ReadKind.NONE:
            klass = VarClass.OUT
        else:
            klass = VarClass.INOUT
        infos[key] = VarInfo(name=key, read=read, write=write, klass=klass,
                             shape=tuple(shape), dtype=dtype)
    return ContextInfo(vars=infos, env_keys=env_keys,
                       update_keys=list(writes), trace=trace)
