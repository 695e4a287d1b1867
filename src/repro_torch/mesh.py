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

:class:`ProcessMesh` spreads the first axis's ranks over the processes of
a ``torch.distributed`` group behind the same interface: a caller loops
over the ranks its process holds (:attr:`Mesh.local_shape`,
:meth:`Mesh.local_ranks`; a stacked mesh holds every rank), and the
results and counters are the stacked mesh's.  :meth:`Mesh.take`,
:meth:`Mesh.total` and :meth:`Mesh.join` are the bookkeeping a stacked
mesh does in place (a rank's value on every process, a sum over
processes, every rank's stack on every process) and count nothing.
"""
from __future__ import annotations

import collections
import math
from typing import Sequence

import torch
import torch.distributed as dist

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
                 device: torch.device, *, rank_dims: Sequence[str] = (),
                 counts: "Mesh | None" = None) -> None:
        """``rank_dims``: axes whose rank dim leads a spec's blocks even at
        size 1 (as everywhere else, a size-1 axis adds none);
        ``counts``: the mesh whose :attr:`launches`, :attr:`bytes` and
        :attr:`log` this one's collectives count on (default: its own)."""
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
        self._rank_dims = frozenset(rank_dims)
        self._counts = self if counts is None else counts

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return f"Mesh({axes}, device={self.device})"

    def reset_counters(self) -> None:
        self.launches.clear()
        self.bytes.clear()

    # -- where the ranks live ---------------------------------------------

    #: the processes the ranks are spread over (a stacked mesh: one)
    processes = 1

    @property
    def local_shape(self) -> dict:
        """Ranks this process holds, per axis: every one."""
        return dict(self.shape)

    def local_ranks(self, axis: str) -> range:
        """Global indices along ``axis`` of the ranks this process holds."""
        return range(self.shape[axis])

    def take(self, x: torch.Tensor, axis: str, rank: int) -> torch.Tensor:
        """Rank ``rank``'s value of the per-rank ``x`` (leading ``axis``
        dim), as one tensor every process holds: the reference's
        ``out_specs=P(axis)`` output read at one row, outside the step.
        No collective of the step, counted nothing."""
        return x[rank]

    def total(self, value):
        """The sum over processes of a process-local value (an int or a
        tensor): bookkeeping that a stacked mesh does in place."""
        return value

    def join(self, x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """Every rank's value of the per-rank ``x`` (``axis``'s rank dim at
        ``dim``), in rank order, on every process: a reassembly that the
        stacked mesh does as layout (the reference's "at the jit level",
        not messages).  Counted nothing."""
        return x

    #: the factor this mesh counts an operand's bytes at (1 but on
    #: :meth:`ProcessMesh.carrying`'s mesh)
    _carried = 1

    def carrying(self, axis: str) -> "Mesh":
        """This mesh, for collectives over the other axes whose operands
        carry the ``axis`` ranks this process holds (a rank dim of them
        rides in the payload): they count as the stacked mesh counts its
        operand, which carries every ``axis`` rank.  A stacked mesh holds
        every rank: itself."""
        return self

    def unshard_local(self, xs: torch.Tensor, spec) -> torch.Tensor:
        """The part of the tensor this process's ranks hold, from their
        blocks (on a stacked mesh: :meth:`unshard`)."""
        return self.unshard(xs, spec)

    def shard_local(self, x: torch.Tensor, spec) -> torch.Tensor:
        """:meth:`unshard_local`'s inverse (on a stacked mesh:
        :meth:`shard`)."""
        return self.shard(x, spec)

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
               payload: int | None = None, scale: int = 1) -> None:
        """One launch of ``op`` over ``group`` ranks and ``x``'s bytes
        times ``scale``; ``payload`` (one rank's bytes for :attr:`log`)
        defaults to those bytes over ``group``."""
        nbytes = x.numel() * x.element_size() * scale * self._carried
        c = self._counts
        c.launches[op] += 1
        c.bytes[op] += nbytes
        if c.log is not None:
            c.log.append((op, group, nbytes // group if payload is None
                          else payload))

    def _check(self, x: torch.Tensor, names) -> None:
        lead = tuple(self.local_shape[a] for a in names)
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

    def _cuts(self, axis: str) -> bool:
        """Whether ``axis`` cuts the tensors a spec lays over it (an axis
        of size 1 cuts nothing and adds no rank dim, unless it is one of
        the ``rank_dims``)."""
        return self.shape[axis] > 1 or axis in self._rank_dims

    def _layout(self, shape, spec):
        """(split shape, permutation to rank-dims-first, rank axes in
        mesh order) of a ``shape`` tensor laid out by ``spec``."""
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        split, rank_pos, block_pos = [], {}, []
        for d, n in enumerate(shape):
            axes = [a for a in spec_axes(spec[d]) if self._cuts(a)]
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
        names = self._rank_axes(spec)
        # one rank's result after gathering the first i + 1 axes: its
        # block times those axes' sizes
        got = math.prod(xs.shape[len(names):]) * xs.element_size()
        for i, a in enumerate(names):
            got *= self.shape[a]
            self.all_gather(xs.movedim(i, 0), a, payload=got)
        return self._join(xs, spec)

    def _rank_axes(self, spec) -> list[str]:
        """The mesh axes whose rank dims lead ``spec``'s blocks."""
        return [a for a in self.axis_names if self._cuts(a)
                and any(a in spec_axes(e) for e in tuple(spec))]

    def _join(self, xs: torch.Tensor, spec) -> torch.Tensor:
        """The whole tensor from its per-rank blocks ``xs``, counting
        nothing."""
        spec = tuple(spec)
        block = xs.shape[len(self._rank_axes(spec)):]
        full = []
        for d, n in enumerate(block):
            e = spec[d] if d < len(spec) else None
            full.append(n * math.prod(self.shape[a] for a in spec_axes(e)))
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
        src = self._pairs(name, perm)
        self._count_ppermute(x, p, len(perm))
        return self._permute_local(x, src)

    def _pairs(self, name: str, perm) -> list[int]:
        """The sending rank of every rank along ``name`` (-1: none),
        checking the pairs."""
        p = self.shape[name]
        src = [-1] * p
        for s, d in perm:
            if not (0 <= s < p and 0 <= d < p) or src[d] != -1:
                raise ValueError(
                    f"ppermute over {name!r} (size {p}): bad or repeated "
                    f"pair ({s}, {d}) in {list(perm)}")
            src[d] = s
        return src

    def _count_ppermute(self, x: torch.Tensor, p: int, pairs: int) -> None:
        """One ``ppermute`` launch; bytes: one rank's value per pair."""
        c = self._counts
        c.launches["ppermute"] += 1
        sent = x[0].numel() * x.element_size() * self._carried
        c.bytes["ppermute"] += pairs * sent
        if c.log is not None:
            c.log.append(("ppermute", p, sent))

    def _permute_local(self, x: torch.Tensor, src) -> torch.Tensor:
        """Rank ``d`` of the result is rank ``src[d]`` of ``x`` (zeros
        where ``src[d]`` is -1)."""
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


#: dtypes a gather or a send carries as another of the same width (gloo
#: has no bool or bfloat16; the bits are moved, never added)
_WIRE = {torch.bool: torch.uint8, torch.bfloat16: torch.float16}


def _wire(t: torch.Tensor) -> torch.Tensor:
    return t.view(_WIRE.get(t.dtype, t.dtype))


class ProcessMesh(Mesh):
    """A mesh whose ranks are spread over the processes of a
    ``torch.distributed`` process group: NCCL on a CUDA device, gloo on
    the CPU (a CUDA tensor is never moved to the host for gloo; any
    other pairing raises).

    **Layout.** :attr:`shape` stays the global shape.  A process holds a
    contiguous block of the FIRST axis's ranks (:attr:`split_axis`; its
    block starts at :attr:`offset`, process ``i`` holding ranks ``[i *
    block, (i + 1) * block)``) and every other axis whole
    (:attr:`local_shape`); a first axis the world size does not divide
    raises.  Per-rank tensors carry the LOCAL rank dims in the stacked
    layout, so a stacked-mesh caller runs unchanged on the ranks it
    holds; :meth:`axis_index` gives their global indices.

    **Collectives.**  Over an axis the process holds whole, every
    collective is the stacked mesh's own.  Over the split axis:

    * ``psum``/``pmax``/``pmin`` gather every rank's operand in rank
      order (one ``all_gather``) and fold it rank by rank as
      :meth:`Mesh.psum` does, so the result is the stacked mesh's bit for
      bit whatever the world size.  The price is the wire: each process
      receives the other ranks' operands, (P - 1)/P x P x S bytes for an
      operand of S bytes a rank, against a ring ``all_reduce``'s
      2 (P - 1)/P x S: P/2 times as much (equal at two processes), paid
      for results that do not depend on how the ranks are spread;
    * ``all_gather`` returns the whole ``(P, ...)`` stack
      (one ``all_gather``), ``all_to_all`` is one
      ``all_to_all_single``, and ``ppermute`` moves the pairs within a
      process in place and sends the pairs that cross processes with
      ``batch_isend_irecv``; a rank no pair targets receives zeros;
    * ``shard`` keeps this process's blocks, ``unshard`` gathers the
      whole tensor (one ``all_gather`` over the split axis, the
      stacked gather over the others).

    ``ppermute`` and ``all_gather`` over the split axis are
    differentiable (``torch.autograd.Function``), as collectives inside a
    step are in the reference's ``shard_map``: each process
    differentiates its own share of the step's loss (its ranks' terms, as
    the train cell's loss is), the shares adding up to the loss.  So a
    permute's gradient is the inverse permute, and a gathered stack's is
    every process's gradient of it summed into the rows of the ranks that
    sent them (``jax.lax.all_gather``'s transpose, ``psum_scatter``): an
    ``all_to_all_single`` of the rows, folded in process order.  A loss
    that every process computes whole from the stack counts once a
    process there.  :meth:`take` reads one rank's value on every process
    (a broadcast, the reference's read of one row of an
    ``out_specs=P(axis)`` output, outside the step): every process then
    runs the same computation on it, the value and its gradient being the
    same everywhere, so the rank's gradient is the one its process holds
    (GPipe's loss on the emissions).

    **Counters.**  :attr:`launches`, :attr:`bytes` and :attr:`log` count
    every collective on every process exactly as the stacked mesh counts
    the same call over all the ranks (the bytes of the whole operand),
    so ``lower_cell`` and :mod:`repro_torch.launch.audit` read the same
    numbers on either mesh.  Over an axis the process holds whole the
    operand is the process's own, and the stacked mesh's where it carries
    no split-axis rank dim; one that carries the process's block of them
    (a rank-2 halo's column ring) goes through :meth:`carrying`'s mesh,
    which counts it ``processes`` times, as the stacked mesh's operand
    carries every block.  :meth:`take`, :meth:`total` and :meth:`join`
    (process bookkeeping and reassembly, which a stacked mesh does in
    place) count nothing.  On ``meta`` tensors nothing is sent: the
    shapes come out as they would."""

    def __init__(self, axis_shapes: Sequence[int], axis_names: Sequence[str],
                 device: torch.device, group=None) -> None:
        super().__init__(axis_shapes, axis_names, device)
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "a ProcessMesh needs an initialised torch.distributed "
                "process group (init_process_group first)")
        backend = str(dist.get_backend(group)).lower()
        want = "nccl" if self.device.type == "cuda" else "gloo"
        if backend != want:
            raise ValueError(
                f"a process mesh on {self.device.type} tensors runs over "
                f"{want}, not {backend}: CUDA tensors go over NCCL and are "
                "never moved to the host for gloo")
        self.group = group
        self.processes = dist.get_world_size(group)
        self.process = dist.get_rank(group)
        self.split_axis = self.axis_names[0]
        n = self.shape[self.split_axis]
        if n % self.processes:
            raise ValueError(
                f"the first mesh axis {self.split_axis!r} ({n} ranks) does "
                f"not split over {self.processes} processes")
        self.block = n // self.processes
        self.offset = self.process * self.block
        # stacked twins that do the arithmetic and count on this mesh's
        # counters: over every rank (a gathered operand, the whole
        # tensor's blocks) and over this process's ranks (the collectives
        # of the axes it holds whole, its blocks, which lead with the
        # split axis's rank dim even when it holds one rank of it)
        self._whole = Mesh(tuple(self.shape.values()), self.axis_names,
                           self.device, counts=self)
        self._local = Mesh(tuple(self.local_shape.values()), self.axis_names,
                           self.device, counts=self,
                           rank_dims=(self.split_axis,) if n > 1 else ())
        self._carrier = _Carrying(self)

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return (f"ProcessMesh({axes}, {self.split_axis} ranks "
                f"{self.offset}..{self.offset + self.block - 1} of process "
                f"{self.process}/{self.processes}, device={self.device})")

    @property
    def local_shape(self) -> dict:
        return {a: self.block if a == self.split_axis else s
                for a, s in self.shape.items()}

    def local_ranks(self, axis: str) -> range:
        if axis == self.split_axis:
            return range(self.offset, self.offset + self.block)
        return range(self.shape[axis])

    def axis_index(self, axis: str) -> torch.Tensor:
        r = self.local_ranks(axis)
        return torch.arange(r.start, r.stop, dtype=torch.int32,
                            device=self.device)

    # -- the wire ---------------------------------------------------------

    def _peer(self, process: int) -> int:
        return (process if self.group is None
                else dist.get_global_rank(self.group, process))

    def _gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every process's ``x`` stacked along ``dim`` in process order
        (``all_gather`` into the blocks of one tensor; its one-tensor
        forms are deprecated in one installed torch and missing in
        another): the split axis's ranks in rank order."""
        xs = x.movedim(dim, 0).contiguous()
        out = torch.empty((self.processes,) + tuple(xs.shape),
                          dtype=x.dtype, device=x.device)
        if x.device.type != "meta":
            dist.all_gather(list(_wire(out).unbind(0)), _wire(xs),
                            group=self.group)
        return out.flatten(0, 1).movedim(0, dim)

    def _exchange(self, x: torch.Tensor, pairs, add: bool = False):
        """Rank ``d`` of the result gets rank ``s`` of ``x`` for every
        ``(s, d)`` of ``pairs`` (summed where ``add``; zeros where no pair
        targets ``d``); ``x`` holds this process's ranks of the split
        axis.  Crossing pairs go by ``batch_isend_irecv``, in one order
        on every process."""
        out = torch.zeros_like(x)
        if x.device.type == "meta":
            return out
        lo, hi = self.offset, self.offset + self.block
        ops, got = [], []
        for tag, (s, d) in enumerate(sorted(pairs, key=lambda p: p[::-1])):
            here_s, here_d = lo <= s < hi, lo <= d < hi
            if here_s and here_d:
                got.append((d - lo, x[s - lo]))
            elif here_s:
                ops.append(dist.P2POp(
                    dist.isend, _wire(x[s - lo].contiguous()),
                    self._peer(d // self.block), self.group, tag))
            elif here_d:
                buf = torch.empty(x.shape[1:], dtype=x.dtype,
                                  device=x.device)
                got.append((d - lo, buf))
                ops.append(dist.P2POp(dist.irecv, _wire(buf),
                                      self._peer(s // self.block),
                                      self.group, tag))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for i, v in got:
            if add:
                out[i] += v
            else:
                out[i] = v
        return out

    # -- collectives --------------------------------------------------------

    def _reduce(self, op: str, x: torch.Tensor, axis) -> torch.Tensor:
        names = self._axes(axis)
        if self.split_axis not in names:
            return getattr(self._local, op)(x, axis)
        self._check(x, names)
        full = self._gather(x, names.index(self.split_axis))
        return getattr(self._whole, op)(full, axis)

    def psum(self, x: torch.Tensor, axis) -> torch.Tensor:
        return self._reduce("psum", x, axis)

    def pmax(self, x: torch.Tensor, axis) -> torch.Tensor:
        return self._reduce("pmax", x, axis)

    def pmin(self, x: torch.Tensor, axis) -> torch.Tensor:
        return self._reduce("pmin", x, axis)

    def all_gather(self, x: torch.Tensor, axis: str, *,
                   payload: int | None = None) -> torch.Tensor:
        (name,) = self._axes(axis)
        if name != self.split_axis:
            return self._local.all_gather(x, axis, payload=payload)
        self._check(x, (name,))
        return _Gather.apply(x, self, payload)

    def all_to_all(self, x: torch.Tensor, axis: str, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
        (name,) = self._axes(axis)
        if name != self.split_axis:
            return self._local.all_to_all(x, axis, split_axis, concat_axis)
        self._check(x, (name,))
        p, n = self.shape[name], x.dim() - 1
        sa, ca = split_axis % n + 1, concat_axis % n + 1
        if x.shape[sa] % p:
            raise ValueError(f"all_to_all over {name!r} (size {p}): split "
                             f"dim {split_axis} of {tuple(x.shape[1:])} "
                             "does not divide")
        self._count("all_to_all", x, p, scale=self.processes)
        # (dst, src, ...) with this process's sources; dst rows by process
        y = x.unflatten(sa, (p, x.shape[sa] // p)).movedim(sa, 0)
        send = y.contiguous()
        recv = torch.empty_like(send)
        if x.device.type != "meta":
            dist.all_to_all_single(_wire(recv), _wire(send),
                                   group=self.group)
        # (source process, my dst, its src, ...) -> (my dst, every src, ...)
        got = recv.unflatten(0, (self.processes, self.block)).transpose(0, 1)
        got = got.flatten(1, 2)
        return got.movedim(1, ca).flatten(ca, ca + 1)

    def ppermute(self, x: torch.Tensor, axis: str, perm) -> torch.Tensor:
        (name,) = self._axes(axis)
        if name != self.split_axis:
            return self._local.ppermute(x, axis, perm)
        self._check(x, (name,))
        src = self._pairs(name, perm)
        self._count_ppermute(x, self.shape[name], len(perm))
        pairs = tuple((s, d) for d, s in enumerate(src) if s >= 0)
        return _Permute.apply(x, self, pairs)

    def take(self, x: torch.Tensor, axis: str, rank: int) -> torch.Tensor:
        if axis != self.split_axis:
            return x[rank]
        return _Take.apply(x, self, rank)

    def join(self, x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        if axis != self.split_axis:
            return x
        return self._gather(x, dim)

    def carrying(self, axis: str) -> Mesh:
        if axis != self.split_axis or self.processes == 1:
            return self
        return self._carrier

    def total(self, value):
        t = torch.as_tensor(value, device=self.device)
        t = t.to(torch.int64) if not t.is_floating_point() else t.clone()
        dist.all_reduce(t, group=self.group)
        return int(t) if not torch.is_tensor(value) else t.to(value.dtype)

    # -- tensors laid out by a tensor-plan spec ----------------------------

    def _names_split(self, spec) -> bool:
        """Whether ``spec`` cuts a dim over the split axis (whose rank
        dim then leads the blocks)."""
        return self.shape[self.split_axis] > 1 and any(
            self.split_axis in spec_axes(e) for e in tuple(spec))

    def shard(self, x: torch.Tensor, spec) -> torch.Tensor:
        blocks = self._whole.shard(x, spec)
        if not self._names_split(spec):
            return blocks
        mine = blocks[self.offset:self.offset + self.block]
        return mine.clone() if self.processes > 1 else mine

    def _whole_blocks_shape(self, xs: torch.Tensor, spec) -> tuple:
        """The shape of every rank's blocks, of which ``xs`` holds this
        process's."""
        if self._names_split(spec):
            return (xs.shape[0] * self.processes,) + tuple(xs.shape[1:])
        return tuple(xs.shape)

    def unshard(self, xs: torch.Tensor, spec) -> torch.Tensor:
        if self._names_split(spec):
            xs = self._gather(xs, 0)
        return self._whole.unshard(xs, spec)

    def unshard_local(self, xs: torch.Tensor, spec) -> torch.Tensor:
        """This process's part of the tensor from its blocks, gathering
        nothing across processes; counted as the stacked mesh counts the
        whole tensor's gathers."""
        self._whole.unshard(torch.empty(self._whole_blocks_shape(xs, spec),
                                        dtype=xs.dtype, device="meta"), spec)
        return self._local._join(xs, spec)

    def shard_local(self, x: torch.Tensor, spec) -> torch.Tensor:
        return self._local.shard(x, spec)


class _Carrying(Mesh):
    """:meth:`ProcessMesh.carrying`'s mesh: the process's ranks, for
    collectives over the axes it holds whole, on the process mesh's
    counters, each operand counted once a process (the operands of every
    process's block of the split axis's ranks, as the stacked mesh's
    operand carries them).  A collective over the split axis raises."""

    def __init__(self, owner: ProcessMesh) -> None:
        super().__init__(tuple(owner.local_shape.values()), owner.axis_names,
                         owner.device, counts=owner)
        self._carried = owner.processes
        self._split = owner.split_axis

    def _axes(self, axis) -> tuple[str, ...]:
        names = super()._axes(axis)
        if self._split in names:
            raise ValueError(f"a collective over the split axis "
                             f"{self._split!r} on the mesh carrying it")
        return names


class _Gather(torch.autograd.Function):
    """``ProcessMesh.all_gather`` over the split axis; the gradient of a
    process's ranks is their rows of every process's gradient of the
    stack, added in process order."""

    @staticmethod
    def forward(ctx, x, mesh, payload):
        ctx.mesh = mesh
        full = mesh._gather(x, 0)
        mesh._whole.all_gather(full, mesh.split_axis, payload=payload)
        return full

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        # (process, its ranks, ...): process q's rows go to process q
        send = g.contiguous().unflatten(0, (m.processes, m.block))
        recv = torch.empty_like(send)
        if g.device.type != "meta":
            dist.all_to_all_single(_wire(recv), _wire(send), group=m.group)
        out = recv[0].clone()
        for q in range(1, m.processes):
            out += recv[q]
        return out, None, None


class _Permute(torch.autograd.Function):
    """``ProcessMesh.ppermute`` over the split axis; its gradient is the
    inverse permute (a rank that sent to several sums their
    gradients)."""

    @staticmethod
    def forward(ctx, x, mesh, pairs):
        ctx.mesh, ctx.pairs = mesh, pairs
        return mesh._exchange(x, pairs)

    @staticmethod
    def backward(ctx, g):
        inv = tuple((d, s) for s, d in ctx.pairs)
        return ctx.mesh._exchange(g, inv, add=True), None, None


class _Take(torch.autograd.Function):
    """``ProcessMesh.take``: rank ``rank``'s value broadcast from the
    process holding it.  Every process computes the same on the value, so
    its gradient is the same on each: the owner's own copy is the rank's
    gradient."""

    @staticmethod
    def forward(ctx, x, mesh, rank):
        owner = rank // mesh.block
        ctx.mesh, ctx.rank, ctx.owner = mesh, rank, owner
        if owner == mesh.process:
            val = x[rank - mesh.offset].contiguous().clone()
        else:
            val = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
        if x.device.type != "meta":
            dist.broadcast(_wire(val), mesh._peer(owner), group=mesh.group)
        ctx.shape = x.shape
        return val

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        out = g.new_zeros(ctx.shape)
        if ctx.owner == m.process:
            out[ctx.rank - m.offset] = g
        return out, None, None


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              device=None) -> Mesh:
    """A stacked-rank mesh on ``device`` (``None``: the CUDA card, raising
    ``RuntimeError`` when there is none)."""
    return Mesh(axis_shapes, axis_names, resolve_device(device))


def make_process_mesh(axis_shapes: Sequence[int],
                      axis_names: Sequence[str], device=None,
                      group=None) -> ProcessMesh:
    """A :class:`ProcessMesh` over ``group`` (default: the world) on
    ``device`` (``None``: the CUDA card, raising when there is none)."""
    return ProcessMesh(axis_shapes, axis_names, resolve_device(device),
                       group)
