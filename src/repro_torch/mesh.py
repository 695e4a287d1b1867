"""In-process stacked-rank mesh and its collectives.

Counterpart of :func:`repro.compat.make_mesh` / ``shard_map`` and of the
``jax.lax`` collectives the block executors call.  P virtual ranks live
on ONE device:

* a **per-rank** tensor carries leading rank dimensions, one per mesh
  axis named by the collective, in that order (``(P, ...)`` on a rank-1
  mesh, ``(P_i, P_j, ...)`` over ``("i", "j")``);
* a **replicated** tensor is one tensor shared by every rank, never P
  copies;
* ``psum``/``pmax``/``pmin`` reduce over the rank dimensions and return a
  replicated tensor; ``all_gather`` returns the stack of every rank's
  value with the gathered axis leading; ``ppermute`` moves each rank's
  value to the rank its ``(src, dst)`` pair names (a rank no pair
  targets receives zeros, as in JAX); ``all_to_all`` sends each rank's
  ``j``-th slice to rank ``j``; ``axis_index`` is an ``arange``.

Chunk-cyclic slabs keep the reference's global layout ``(n_loc, P, c,
...)``, whose dim 1 is the rank axis (the reference's ``P(None, axis)``
sharding); the compute phase reads each rank's slabs from that dim.

A tensor sharded by a tensor-plan spec (:mod:`repro_torch.core.
tensor_plan`) is stored as its per-rank blocks: :meth:`Mesh.shard`
lays it out with one leading rank dim per mesh axis the spec names (in
mesh order; an axis of size 1 cuts nothing and adds no dim), each
block as ``NamedSharding`` lays it out, and :meth:`Mesh.unshard` gathers
it back, one ``all_gather`` per such axis.

Every collective counts one launch and the bytes of its per-rank
operands in :attr:`Mesh.launches` / :attr:`Mesh.bytes` — the port's
counterpart of the reference's HLO collective audit: ``psum``,
``pmax``, ``pmin``, ``all_gather`` (the gathers of :meth:`Mesh.unshard`
too), ``all_to_all`` and ``ppermute`` (the bytes its sending ranks put
on the wire).  :meth:`Mesh.shard` moves nothing between ranks (each
keeps its own block) and counts nothing.  While :attr:`Mesh.log` is a
list, each collective also appends ``(op, group size, payload)``, the
payload being one rank's bytes as the reference's HLO audit takes them
(an all-reduce's operand, an all-gather's gathered result, an
all-to-all's operand, a permute's sent value): what
:mod:`repro_torch.launch.audit` prices on the wire.
"""
from __future__ import annotations

import collections
import math
from typing import Sequence

import torch

from repro_torch.core.tensor_plan import spec_axes


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; raise rather than run on the CPU
    when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' explicitly to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


class Mesh:
    """P virtual ranks on one device, with named axes."""

    def __init__(self, axis_shapes: Sequence[int], axis_names: Sequence[str],
                 device: torch.device) -> None:
        axis_shapes = tuple(int(s) for s in axis_shapes)
        axis_names = tuple(str(a) for a in axis_names)
        if len(axis_shapes) != len(axis_names) or not axis_names:
            raise ValueError(
                f"mesh shape {axis_shapes} and axis names {axis_names} "
                "must have the same (non-zero) length")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"duplicate mesh axis names {axis_names}")
        if any(s < 1 for s in axis_shapes):
            raise ValueError(f"mesh axis sizes must be >= 1, got {axis_shapes}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, axis_shapes))
        self.device = device
        self.launches: collections.Counter = collections.Counter()
        self.bytes: collections.Counter = collections.Counter()
        #: ``None``, or a list that every collective appends
        #: ``(op, group size, one rank's payload bytes)`` to
        self.log: list | None = None
        self._perms: dict = {}

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return f"Mesh({axes}, device={self.device})"

    def reset_counters(self) -> None:
        self.launches.clear()
        self.bytes.clear()

    # -- rank identity ------------------------------------------------------

    def axis_index(self, axis: str) -> torch.Tensor:
        """Every rank's index along ``axis``: ``arange(P_axis)`` (int32)."""
        return torch.arange(self.shape[axis], dtype=torch.int32,
                            device=self.device)

    # -- collectives over the leading rank dimensions -----------------------

    def _axes(self, axis) -> tuple[str, ...]:
        names = axis if isinstance(axis, tuple) else (axis,)
        for a in names:
            if a not in self.shape:
                raise ValueError(f"axis {a!r} not in mesh axes "
                                 f"{self.axis_names}")
        return names

    def _count(self, op: str, x: torch.Tensor, group: int,
               payload: int | None = None) -> None:
        """One launch of ``op`` over ``group`` ranks and ``x``'s bytes;
        ``payload`` (one rank's bytes for :attr:`log`) defaults to
        ``x``'s bytes over ``group``."""
        nbytes = x.numel() * x.element_size()
        self.launches[op] += 1
        self.bytes[op] += nbytes
        if self.log is not None:
            self.log.append((op, group, nbytes // group if payload is None
                             else payload))

    def _check(self, x: torch.Tensor, names) -> None:
        lead = tuple(self.shape[a] for a in names)
        if tuple(x.shape[:len(lead)]) != lead:
            raise ValueError(
                f"per-rank tensor over {names} needs leading dims {lead}, "
                f"got shape {tuple(x.shape)}")

    def psum(self, x: torch.Tensor, axis) -> torch.Tensor:
        """Sum over the rank dims, folded rank by rank in rank order:
        the same additions in the same order whatever else shares the
        operand, so fused (concatenated) and per-operand combines agree
        bit for bit on every device."""
        names = self._axes(axis)
        self._check(x, names)
        self._count("psum", x, math.prod(self.shape[a] for a in names))
        ranks = x.flatten(0, len(names) - 1) if len(names) > 1 else x
        out = ranks[0].clone()
        for r in range(1, ranks.shape[0]):
            out += ranks[r]
        return out

    def pmax(self, x: torch.Tensor, axis) -> torch.Tensor:
        names = self._axes(axis)
        self._check(x, names)
        self._count("pmax", x, math.prod(self.shape[a] for a in names))
        return x.flatten(0, len(names) - 1).amax(dim=0)

    def pmin(self, x: torch.Tensor, axis) -> torch.Tensor:
        names = self._axes(axis)
        self._check(x, names)
        self._count("pmin", x, math.prod(self.shape[a] for a in names))
        return x.flatten(0, len(names) - 1).amin(dim=0)

    def all_gather(self, x: torch.Tensor, axis: str, *,
                   payload: int | None = None) -> torch.Tensor:
        """Gather along ONE axis: every rank receives the stack of its
        axis peers' values.  In the stacked layout that stack already
        leads ``x``; the launch and its bytes are what is recorded.
        ``payload`` is one rank's gathered result in bytes for
        :attr:`log` (default: ``x``'s bytes, the stack of one value a
        rank)."""
        (name,) = self._axes(axis)
        self._check(x, (name,))
        self._count("all_gather", x, self.shape[name],
                    x.numel() * x.element_size() if payload is None
                    else payload)
        return x

    def all_to_all(self, x: torch.Tensor, axis: str, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
        """``jax.lax.all_to_all`` over ONE axis: every rank cuts its value
        into P slices along ``split_axis`` and sends slice ``j`` to rank
        ``j``; each rank concatenates what it receives along
        ``concat_axis``, in source-rank order.  The axes index a rank's
        value (``x`` without its leading rank dim)."""
        (name,) = self._axes(axis)
        self._check(x, (name,))
        p, n = self.shape[name], x.dim() - 1
        sa, ca = split_axis % n + 1, concat_axis % n + 1
        if x.shape[sa] % p:
            raise ValueError(f"all_to_all over {name!r} (size {p}): split "
                             f"dim {split_axis} of {tuple(x.shape[1:])} "
                             "does not divide")
        self._count("all_to_all", x, p)
        y = x.unflatten(sa, (p, x.shape[sa] // p)).movedim(sa, 0)
        # (dst, src, ...): the source rank goes just before the concat dim
        return y.movedim(1, ca).flatten(ca, ca + 1)

    # -- tensors laid out by a tensor-plan spec ----------------------------

    def _layout(self, shape, spec):
        """(split shape, permutation to rank-dims-first, rank axes in
        mesh order) of a ``shape`` tensor laid out by ``spec``."""
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        split, rank_pos, block_pos = [], {}, []
        for d, n in enumerate(shape):
            axes = [a for a in spec_axes(spec[d]) if self.shape[a] > 1]
            for a in axes:
                rank_pos[a] = len(split)
                split.append(self.shape[a])
            k = math.prod(self.shape[a] for a in axes)
            if n % k:
                raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                                 f"over {spec[d]!r} ({k} ranks)")
            block_pos.append(len(split))
            split.append(n // k)
        order = [a for a in self.axis_names if a in rank_pos]
        return split, [rank_pos[a] for a in order] + block_pos, order

    def shard(self, x: torch.Tensor, spec) -> torch.Tensor:
        """``x`` as its per-rank blocks by ``spec``: ``(P_a, ..., *block)``
        over the mesh axes ``spec`` names (mesh order).  Each rank keeps
        its own block: nothing moves, nothing is counted."""
        split, perm, _ = self._layout(x.shape, spec)
        return x.reshape(split).permute(perm).contiguous()

    def unshard(self, xs: torch.Tensor, spec) -> torch.Tensor:
        """The whole tensor from its per-rank blocks (:meth:`shard`'s
        inverse): one counted ``all_gather`` per rank axis."""
        spec = tuple(spec)
        names = [a for a in self.axis_names if self.shape[a] > 1
                 and any(a in spec_axes(e) for e in spec)]
        block = xs.shape[len(names):]
        full = []
        for d, n in enumerate(block):
            e = spec[d] if d < len(spec) else None
            full.append(n * math.prod(self.shape[a] for a in spec_axes(e)))
        # one rank's result after gathering the first i + 1 axes: its
        # block times those axes' sizes
        got = math.prod(block) * xs.element_size()
        for i, a in enumerate(names):
            got *= self.shape[a]
            self.all_gather(xs.movedim(i, 0), a, payload=got)
        split, perm, _ = self._layout(full, spec)
        inv = [0] * len(perm)
        for i, q in enumerate(perm):
            inv[q] = i
        return xs.permute(inv).reshape(full)

    def ppermute(self, x: torch.Tensor, axis: str, perm) -> torch.Tensor:
        """Point-to-point shifts along ONE axis: rank ``dst`` receives
        rank ``src``'s value for every ``(src, dst)`` pair of ``perm``;
        a rank no pair targets receives zeros.  ``x`` leads with that
        axis's rank dim (other mesh axes' rank dims ride in the payload).
        Counts one launch and the bytes the sending ranks put on the
        wire."""
        (name,) = self._axes(axis)
        self._check(x, (name,))
        p = self.shape[name]
        src = [-1] * p
        for s, d in perm:
            if not (0 <= s < p and 0 <= d < p) or src[d] != -1:
                raise ValueError(
                    f"ppermute over {name!r} (size {p}): bad or repeated "
                    f"pair ({s}, {d}) in {list(perm)}")
            src[d] = s
        self.launches["ppermute"] += 1
        sent = x[0].numel() * x.element_size()
        self.bytes["ppermute"] += len(perm) * sent
        if self.log is not None:
            self.log.append(("ppermute", p, sent))
        idx, dst = self._perm_index(tuple(src))
        if dst is None:             # every rank receives: one gather
            return x.index_select(0, idx)
        # some ranks receive nothing: zeros, and only the sent rows copied
        out = torch.zeros_like(x)
        return out.index_copy_(0, dst, x.index_select(0, idx))

    def _perm_index(self, src: tuple[int, ...]):
        """Per permutation (cached on the device): the sending rank of
        every rank, or, when some rank receives nothing, the sending
        ranks and the receiving ranks of its pairs."""
        got = self._perms.get(src)
        if got is None:
            if min(src) >= 0:
                got = (torch.tensor(src, device=self.device), None)
            else:
                pairs = [(s, d) for d, s in enumerate(src) if s >= 0]
                got = tuple(torch.tensor(t, dtype=torch.long,
                                         device=self.device).reshape(-1)
                            for t in zip(*pairs)) if pairs else (
                    torch.zeros(0, dtype=torch.long, device=self.device),) * 2
            self._perms[src] = got
        return got


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              device=None) -> Mesh:
    """A stacked-rank mesh on ``device`` (``None``: the CUDA card, raising
    ``RuntimeError`` when there is none)."""
    return Mesh(axis_shapes, axis_names, resolve_device(device))
