"""Loop-nest IR — the single owner of iteration-space geometry
(counterpart of :mod:`repro.core.nest`).

* **axes** — one canonical :class:`~repro_torch.core.loop.LoopInfo` per
  induction variable (rank 1 or 2);
* **affine access maps** — :class:`NestAffine` (``a_i*i + a_j*j + b``);
* **window geometry** — where chunk ``j``'s read window lives in the
  buffer (``window_rows`` / ``device_window_rows`` / ``window_extent``);
* **slab slicing** — the chunk-cyclic pad/reshape staging
  (:func:`pad_reshape`, :func:`halo_slabs`, :func:`halo_slabs2`,
  :func:`unpad_flat`, :func:`unpad_flat2`) and the rank-local slicing of
  a replicated buffer (:func:`local_slabs`, :func:`local_slabs2`);
* **env substitution** — :class:`ShiftedWindow` serves ``x[i]`` /
  ``x[i, j]``-style body reads from a slab window;
* **kernel tiles** — :class:`AxisTiles` / :func:`derive_axis_tiles`, the
  lane tiling of one chunk for the span kernel.

Chunk-cyclic layout (per axis): iteration ``k`` lives in chunk ``k // c``;
chunk ``j`` executes on rank ``j % P`` as local chunk ``j // P``; the
padded axis reshapes to ``(n_loc, P, c)`` whose middle dim IS the rank
axis.  A rank-2 nest composes two such layouts:
``(n_i, P_i, c_i, n_j, P_j, c_j, *rest)``.

A process of a :class:`~repro_torch.mesh.ProcessMesh` holds a *rank
window* ``(lo, block)`` of the first nest axis's ranks
(:func:`rank_window`): its slot tables, staged slabs and dense values are
``(n_loc, block, c, ...)`` — columns ``lo .. lo + block - 1`` of the
global layout, staged from its own slots only — and a ``window`` of
``None`` is every rank (a stacked mesh).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.loop import LoopInfo, LoopNotCanonical, analyze_loop


# ---------------------------------------------------------------------------
# The nest IR
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LoopNest:
    """A rank-1 or rank-2 canonical loop nest (``collapse(2)`` semantics:
    the iteration space is the cross product of the axes)."""

    axes: tuple[LoopInfo, ...]

    def __post_init__(self) -> None:
        if not 1 <= len(self.axes) <= 2:
            raise LoopNotCanonical(
                f"loop nests of rank {len(self.axes)} are not supported "
                "(collapse(2) is the maximum)")

    @property
    def rank(self) -> int:
        return len(self.axes)

    @property
    def trip_counts(self) -> tuple[int, ...]:
        return tuple(ax.trip_count for ax in self.axes)

    @property
    def total_trip(self) -> int:
        return math.prod(ax.trip_count for ax in self.axes)

    @classmethod
    def from_program(cls, program) -> "LoopNest":
        return cls(tuple(analyze_loop(s, e, t) for s, e, t in program.bounds))


@dataclasses.dataclass(frozen=True)
class NestAffine:
    """Index affine in the nest iterators: ``sum_d coeffs[d]*i_d + b``."""

    coeffs: tuple[int, ...]
    b: int

    def __add__(self, other: "NestAffine") -> "NestAffine":
        return NestAffine(
            tuple(a + o for a, o in zip(self.coeffs, other.coeffs)),
            self.b + other.b)

    def __sub__(self, other: "NestAffine") -> "NestAffine":
        return NestAffine(
            tuple(a - o for a, o in zip(self.coeffs, other.coeffs)),
            self.b - other.b)

    def scale(self, k: int) -> "NestAffine":
        return NestAffine(tuple(a * k for a in self.coeffs), self.b * k)

    @property
    def is_const(self) -> bool:
        return all(a == 0 for a in self.coeffs)

    def k_space(self, nest: LoopNest) -> "NestAffine":
        """Rebase from iterator space to iteration-number space."""
        coeffs = tuple(a * ax.step for a, ax in zip(self.coeffs, nest.axes))
        b = self.b + sum(a * ax.start
                         for a, ax in zip(self.coeffs, nest.axes))
        return NestAffine(coeffs, b)

    def __repr__(self) -> str:
        names = ("i", "j", "k")
        terms = [("" if a == 1 else f"{a}*") + names[d]
                 for d, a in enumerate(self.coeffs) if a != 0]
        if not terms:
            return str(self.b)
        s = "+".join(terms)
        return s if self.b == 0 else f"{s}{self.b:+d}"


# ---------------------------------------------------------------------------
# Window geometry
# ---------------------------------------------------------------------------


def window_extent(chunk: int, halo: tuple[int, int]) -> int:
    """Width of one chunk's read window: ``chunk + (b_max - b_min)``."""
    b_min, b_max = halo
    return chunk + (b_max - b_min)


def slot_chunk_ids(ch) -> np.ndarray:
    """Global chunk id at each slot position (identity for the cyclic
    deal; the plan's ``slot_map`` for straggler-weighted schedules)."""
    if ch.slot_map is not None:
        return np.asarray(ch.slot_map, dtype=np.int64)
    return np.arange(ch.num_chunks, dtype=np.int64)


def restore_chunk_order(ch) -> np.ndarray | None:
    """Slot index of every *real* chunk, in global chunk order (``None``
    for the cyclic deal)."""
    if ch.slot_map is None:
        return None
    inv = np.empty(ch.real_chunks, dtype=np.int64)
    for s, j in enumerate(ch.slot_map):
        if j < ch.real_chunks:
            inv[j] = s
    return inv


def rank_window(mesh, axis) -> tuple[int, int] | None:
    """The ranks of the first nest axis (``axis``, or ``axis[0]`` for a
    rank-2 nest) this process holds, as ``(lo, block)``; ``None`` where it
    holds them all (a stacked mesh, an axis not split over processes).
    A rank-2 nest splits only its ``i`` axis's ranks."""
    axes = axis if isinstance(axis, tuple) else (axis,)
    for a in axes[1:]:
        if len(mesh.local_ranks(a)) != mesh.shape[a]:
            raise NotImplementedError(
                f"a rank-2 nest over {axes} on {mesh!r}: its j axis {a!r} "
                "is split over processes; a process mesh splits the nest's "
                "i axis only (put it first in the mesh)")
    r = mesh.local_ranks(axes[0])
    return None if len(r) == mesh.shape[axes[0]] else (r.start, len(r))


def slot_table(ch, window=None) -> np.ndarray:
    """Global chunk id of every (local chunk, rank) slot, ``(n_loc, P)``
    — or ``(n_loc, block)``, the columns of a rank ``window``."""
    ids = slot_chunk_ids(ch).reshape(ch.local_chunks, ch.num_devices)
    if window is not None:
        lo, block = window
        ids = ids[:, lo:lo + block]
    return ids


def slot_iterations(ch, device, window=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every (local chunk, rank) slot's global chunk id ``(n_loc, P)`` and
    the iteration number of each of its lanes ``(n_loc, P, c)`` — the
    chunk-cyclic deal (or the weighted ``slot_map``) as tensors; the
    ``block`` ranks of a rank ``window`` in place of ``P``."""
    js = torch.as_tensor(slot_table(ch, window), device=device)
    return js, js[..., None] * ch.chunk + torch.arange(ch.chunk,
                                                       device=device)


def window_rows(ch, halo: tuple[int, int], nrows: int,
                device=None, window=None) -> torch.Tensor:
    """Row indices of every chunk's read window, ``(num_chunks, width)``
    in slot order (the slots of a rank ``window`` only), clipped
    in-bounds (out-of-range rows are only ever consumed by masked
    padding lanes).  Built on ``device``: at EXTRALARGE sizes the index
    array is as large as the buffer."""
    b_min, _ = halo
    width = window_extent(ch.chunk, halo)
    js = torch.as_tensor(slot_table(ch, window).reshape(-1), device=device)
    rows = (js[:, None] * ch.chunk + b_min
            + torch.arange(width, device=device)[None, :])
    return rows.clamp(0, max(0, nrows - 1))


def device_window_rows(ch, halo: tuple[int, int], device_index,
                       nrows: int, device=None) -> torch.Tensor:
    """Row indices of one rank's chunk windows, ``(local_chunks, width)``;
    ``device_index`` may be an int or a tensor of rank indices (then the
    result gains its leading dims)."""
    b_min, _ = halo
    width = window_extent(ch.chunk, halo)
    d = torch.as_tensor(device_index, dtype=torch.int64, device=device)
    q = torch.arange(ch.local_chunks, dtype=torch.int64, device=d.device)
    base = (q * ch.num_devices + d[..., None]) * ch.chunk
    rows = (base[..., None] + b_min
            + torch.arange(width, dtype=torch.int64, device=d.device))
    return rows.clamp(0, max(0, nrows - 1))


# ---------------------------------------------------------------------------
# Slab slicing — staging (chunk-cyclic pad/reshape)
# ---------------------------------------------------------------------------


def _index(x: torch.Tensor, idx, dim: int = 0) -> torch.Tensor:
    return torch.index_select(
        x, dim, torch.as_tensor(idx, device=x.device).reshape(-1))


def pad_reshape(x: torch.Tensor, ch, window=None) -> torch.Tensor:
    """(T, *rest) -> (n_loc, P, c, *rest) chunk-cyclic (or slot-ordered)
    layout; ``(n_loc, block, c, *rest)`` for a rank ``window``, whose
    slots' rows alone are read (rows past ``T`` are zeros, as the
    padding)."""
    rest = tuple(x.shape[1:])
    if window is not None:
        n = x.shape[0]
        rows = (torch.as_tensor(slot_table(ch, window), device=x.device)
                [..., None] * ch.chunk
                + torch.arange(ch.chunk, device=x.device))
        got = _index(x, rows.clamp(max=max(0, n - 1))).reshape(
            tuple(rows.shape) + rest)
        if ch.padded_trip > n:
            keep = (rows < n).reshape(tuple(rows.shape) + (1,) * len(rest))
            got = got.masked_fill(~keep, 0)
        return got
    pad = ch.padded_trip - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    if ch.slot_map is not None:
        chunks = x.reshape((ch.num_chunks, ch.chunk) + tuple(x.shape[1:]))
        x = _index(chunks, slot_chunk_ids(ch)).reshape(
            (ch.padded_trip,) + tuple(x.shape[1:]))
    return x.reshape((ch.local_chunks, ch.num_devices, ch.chunk)
                     + tuple(x.shape[1:]))


def _ranks(ch, window) -> int:
    """Rank columns of the layout: ``P``, or a rank window's ``block``."""
    return ch.num_devices if window is None else window[1]


def halo_slabs(x: torch.Tensor, ch, halo: tuple[int, int],
               window=None) -> torch.Tensor:
    """(N, *rest) -> (n_loc, P, c + halo_width, *rest): each chunk's slab
    carries its read window (rows duplicated at chunk edges); ``block``
    in place of ``P`` for a rank ``window``."""
    width = window_extent(ch.chunk, halo)
    rows = window_rows(ch, halo, x.shape[0], x.device, window)
    slab = _index(x, rows)
    return slab.reshape((ch.local_chunks, _ranks(ch, window), width)
                        + tuple(x.shape[1:]))


def halo_slabs2(x: torch.Tensor, chs, halos, window=None) -> torch.Tensor:
    """(N0, N1, *rest) -> (n_i, P_i, w_i, n_j, P_j, w_j, *rest); a rank
    ``window`` cuts the ``i`` axis's ranks."""
    ch_i, ch_j = chs
    halo_i, halo_j = halos
    rows_i = window_rows(ch_i, halo_i, x.shape[0], x.device, window)
    rows_j = window_rows(ch_j, halo_j, x.shape[1], x.device)   # (K_j, w_j)
    slab = _index(_index(x, rows_i, 0), rows_j, 1)   # (K_i*w_i, K_j*w_j, *)
    return slab.reshape(
        (ch_i.local_chunks, _ranks(ch_i, window), rows_i.shape[1],
         ch_j.local_chunks, ch_j.num_devices, rows_j.shape[1])
        + tuple(x.shape[2:]))


def unpad_flat(slabs: torch.Tensor, ch, t: int) -> torch.Tensor:
    """(n_loc, P, c, *rest) -> (T, *rest), undoing a weighted slot order."""
    rest = tuple(slabs.shape[3:])
    inv = restore_chunk_order(ch)
    if inv is None:
        return slabs.reshape((ch.padded_trip,) + rest)[:t]
    chunks = slabs.reshape((ch.num_chunks, ch.chunk) + rest)
    flat = _index(chunks, inv).reshape((len(inv) * ch.chunk,) + rest)
    return flat[:t]


def unpad_flat2(slabs: torch.Tensor, chs, trips) -> torch.Tensor:
    """(n_i, P_i, c_i, n_j, P_j, c_j, *rest) -> (T_i, T_j, *rest)."""
    ch_i, ch_j = chs
    t_i, t_j = trips
    rest = tuple(slabs.shape[6:])
    inv_i = restore_chunk_order(ch_i)
    inv_j = restore_chunk_order(ch_j)
    if inv_i is None and inv_j is None:
        flat = slabs.reshape((ch_i.padded_trip, ch_j.padded_trip) + rest)
        return flat[:t_i, :t_j]
    idx_i = inv_i if inv_i is not None else np.arange(ch_i.num_chunks)
    idx_j = inv_j if inv_j is not None else np.arange(ch_j.num_chunks)
    chunks = slabs.reshape(
        (ch_i.num_chunks, ch_i.chunk, ch_j.num_chunks, ch_j.chunk) + rest)
    chunks = _index(_index(chunks, idx_i, 0), idx_j, 2)
    flat = chunks.reshape((len(idx_i) * ch_i.chunk,
                           len(idx_j) * ch_j.chunk) + rest)
    return flat[:t_i, :t_j]


# ---------------------------------------------------------------------------
# Slab slicing — rank-local windows of a replicated buffer
# ---------------------------------------------------------------------------


def local_slabs(x: torch.Tensor, ch, halo: tuple[int, int],
                device_index) -> torch.Tensor:
    """One rank's chunk slabs out of a replicated buffer,
    ``(n_loc, width, *rest)`` — same geometry as :func:`halo_slabs`."""
    rows = device_window_rows(ch, halo, device_index, x.shape[0], x.device)
    return x[rows]


def local_slabs2(x: torch.Tensor, chs, halos, device_indices) -> torch.Tensor:
    """Rank-2 :func:`local_slabs`: ``(n_i, w_i, n_j, w_j, *rest)``."""
    ch_i, ch_j = chs
    halo_i, halo_j = halos
    d_i, d_j = device_indices
    rows_i = device_window_rows(ch_i, halo_i, d_i, x.shape[0], x.device)
    rows_j = device_window_rows(ch_j, halo_j, d_j, x.shape[1], x.device)
    return x[rows_i[:, :, None, None], rows_j[None, None, :, :]]


# ---------------------------------------------------------------------------
# Kernel tiles — the span kernel's lane geometry (Hopper rule)
# ---------------------------------------------------------------------------

#: Lanes of one kernel tile along the last nest axis: a power of two in
#: [MIN_TILE_LANES, MAX_TILE_LANES] — at least one warp wide, and at most
#: 1024 lanes so a tile's values stay in registers (8 per thread at
#: four warps).
MIN_TILE_LANES = 32
MAX_TILE_LANES = 1024


def pow2_at_least(n: int) -> int:
    """The least power of two >= ``n`` (1 for ``n <= 1``)."""
    return 1 << max(0, int(n) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class AxisTiles:
    """Tiling of one axis's chunk lanes for the span kernel: ``n_tiles``
    tiles of ``tile`` lanes cover the ``chunk`` lanes; the last tile's
    ``masked_lanes`` trailing lanes are padding (masked on store, their
    iteration numbers clamp like the trip padding)."""

    chunk: int
    tile: int
    n_tiles: int
    padded: int

    @property
    def masked_lanes(self) -> int:
        return self.padded - self.chunk

    def cover(self) -> list[tuple[int, int]]:
        """``(start_lane, valid_lanes)`` per tile — a partition of
        ``[0, chunk)`` with no overlap and no gap."""
        return [(ti * self.tile, min(self.tile, self.chunk - ti * self.tile))
                for ti in range(self.n_tiles)]


def derive_axis_tiles(chunk: int, max_tile: int = MAX_TILE_LANES,
                      min_tile: int = MIN_TILE_LANES) -> AxisTiles:
    """Tile one axis's chunk: ``tile`` is the chunk rounded up to a power
    of two, clamped to ``[min_tile, max_tile]``; remainder lanes of the
    last tile are masked."""
    tile = min(max(pow2_at_least(max(int(chunk), 1)), int(min_tile)),
               int(max_tile))
    n_tiles = max(1, -(-int(chunk) // tile))
    return AxisTiles(chunk=int(chunk), tile=tile, n_tiles=n_tiles,
                     padded=n_tiles * tile)


def derive_nest_tiles(chunks: tuple[int, ...],
                      max_lanes: int = MAX_TILE_LANES,
                      min_tile: int = MIN_TILE_LANES, min_lead: int = 1,
                      max_last: int | None = None) -> tuple[AxisTiles, ...]:
    """Tiles of a rank-1 or rank-2 nest: the last axis takes the lane
    rule (``[min_tile, max_last or max_lanes]``); a leading axis fills the
    rest of a ``max_lanes`` budget (``tile_i * tile_j <= max_lanes``, a
    power of two >= ``min_lead``).  The defaults are the pointwise
    template's; the span kernel asks for narrower tiles of at least 16
    lanes an axis where ``tl.dot`` takes the lanes as a matrix dim."""
    last = derive_axis_tiles(chunks[-1], max_tile=max_last or max_lanes,
                             min_tile=min_tile)
    if len(chunks) == 1:
        return (last,)
    first = derive_axis_tiles(chunks[0],
                              max_tile=max(min_lead, max_lanes // last.tile),
                              min_tile=min_lead)
    return (first, last)


# ---------------------------------------------------------------------------
# Env substitution: sliced-read service from a slab window
# ---------------------------------------------------------------------------


class SubstitutionFailed(Exception):
    pass


class ShiftedWindow:
    """Stands in for a shared buffer whose accesses are ``x[i]`` /
    ``x[i, j]``-style reads on the leading axes; serves them from a
    chunk window.

    ``offsets[d]`` is the global position held by window row 0 of axis
    ``d``: reading ``x[a, b]`` returns ``window[a - offsets[0], b -
    offsets[1]]``, each row clamped into the window (the reference's
    ``dynamic_index_in_dim`` clamps too; only masked padding lanes ever
    need it).  Axes beyond ``len(offsets)`` pass through untouched.
    """

    def __init__(self, window, offsets: tuple, virtual_shape, dtype):
        self._win = window
        self._offsets = tuple(offsets)
        self.shape = tuple(virtual_shape)
        self.dtype = dtype
        self.ndim = len(self.shape)

    def __getitem__(self, idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        r = len(self._offsets)
        if len(idx) < r:
            raise SubstitutionFailed(
                f"sliced-read substitution needs {r} leading indices, "
                f"got {len(idx)}")
        rows = tuple(self._row(d, torch.as_tensor(ix))
                     for d, ix in enumerate(idx[:r]))
        out = self._win[rows]
        rest = tuple(idx[r:])
        return out[rest] if rest else out

    def _row(self, d, ix):
        return torch.clamp(ix - self._offsets[d], 0, self._win.shape[d] - 1)

    def __len__(self):
        return self.shape[0]

    def _no(self, *a, **k):  # pragma: no cover - guard path
        raise SubstitutionFailed(
            "sliced-read substitution saw a non-getitem use; this buffer "
            "should have been classified as a whole-array read"
        )

    __add__ = __radd__ = __mul__ = __rmul__ = __sub__ = __rsub__ = _no
    __truediv__ = __rtruediv__ = __matmul__ = __rmatmul__ = _no
    __neg__ = __pow__ = __array__ = _no


class ClampedArray(ShiftedWindow):
    """A whole array whose sliced reads (``x[a*i+b]`` on the leading
    ``ndim`` axes) index it as ``jnp`` indexing does: a negative index
    wraps once (adds the axis length), then clamps into bounds, so a read
    past either end gives the edge element as in the reference (K1 reads
    replicated arrays so too).  :func:`clamp_if_sliced` puts it in place
    of each replicated array that Context Analysis classifies as a sliced
    read."""

    def __init__(self, array, ndim: int = 1):
        super().__init__(array, (0,) * ndim, array.shape, array.dtype)

    def _row(self, d, ix):
        n = self._win.shape[d]
        return torch.clamp(torch.where(ix < 0, ix + n, ix), 0, n - 1)


def clamp_if_sliced(array, read):
    """``array`` wrapped in :class:`ClampedArray` when the body reads it
    sliced (``read``, its ``ReadInfo``, is ``SLICED`` or ``STENCIL``);
    an array read whole stays the plain tensor."""
    from repro_torch.core.context import ReadKind

    if read.kind in (ReadKind.SLICED, ReadKind.STENCIL):
        return ClampedArray(array, read.slice_ndim or 1)
    return array
