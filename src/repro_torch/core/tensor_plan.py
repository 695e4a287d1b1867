"""Tensor-level distribution planning: "pragmas for tensors" — the
counterpart of :mod:`repro.core.tensor_plan`.

A matmul *is* a parallel loop nest, so the paper's derivation generalises:
every model tensor (param or activation) carries a tuple of *logical axis*
names — the loop variables of the nest it participates in — and the
planner maps logical axes onto mesh axes, exactly as
:mod:`repro_torch.core.plan` maps the explicit-loop iteration space onto
the device axis:

* a dim whose logical axis maps to a mesh axis is *chunk-distributed*
  (the paper's OUT-slice rule -> sharded),
* a dim with no mapping is *replicated* (the paper's IN-broadcast rule),
* contractions over a mapped axis become ``psum``-style partials (the
  reduction clause).

Divisibility-aware first-fit: a rule only fires when the dim size is
divisible by the mesh-axis extent (e.g. GQA kv=8 heads cannot shard over
a 16-way model axis -> replicated); each mesh axis is used at most once
per tensor.

The planner is pure data: its :class:`PartitionSpec` is a tuple of
entries (``None``, a mesh axis name or a tuple of names) with trailing
``None`` entries trimmed, and equals the reference's ``PartitionSpec``
entry for entry.  On the port's stacked mesh
(:class:`repro_torch.mesh.Mesh`) a spec lays a tensor out as per-rank
blocks (:meth:`~repro_torch.mesh.Mesh.shard`), and
:meth:`TensorPlan.constrain` is the identity on values, as
``with_sharding_constraint`` is.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Mapping, Sequence


# Logical axis vocabulary used by the model stack.
BATCH = "batch"
SEQ = "seq"
SEQ_KV = "seq_kv"
D_MODEL = "d_model"
HEADS = "heads"
KV_HEADS = "kv_heads"
HEAD_DIM = "head_dim"
D_FF = "d_ff"
VOCAB = "vocab"
EXPERTS = "experts"
D_EXPERT = "d_expert"
LAYERS = "layers"          # the stacked leading dim of a period's slots
D_INNER = "d_inner"        # mamba
D_STATE = "d_state"
CONV = "conv"
GROUPS = "groups"          # MoE dispatch groups
FRAMES = "frames"          # whisper encoder positions


class PartitionSpec(tuple):
    """``PartitionSpec(*entries)``: per dim ``None`` (replicated), a mesh
    axis name, or a tuple of names (the dim's blocks laid out over those
    axes in row-major order); dims past the last entry are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes one spec entry names (``()`` for ``None``)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


@dataclasses.dataclass(frozen=True)
class TensorPlan:
    """Maps logical axes to (prioritised lists of) mesh axes."""

    mesh_axes: tuple[str, ...]
    mesh_shape: tuple[int, ...]
    rules: Mapping[str, tuple]     # logical -> tuple of candidates; each
                                   # candidate is a mesh axis or axis-tuple
    #: constrained activations by spec (:meth:`constrain`)
    constrained: collections.Counter = dataclasses.field(
        default_factory=collections.Counter, compare=False, repr=False)

    def _axis_size(self, axis) -> int:
        if isinstance(axis, tuple):
            n = 1
            for a in axis:
                n *= self._axis_size(a)
            return n
        return self.mesh_shape[self.mesh_axes.index(axis)]

    def spec(self, shape: Sequence[int], axes: Sequence[str | None]) -> P:
        """Divisibility-aware first-fit assignment of mesh axes to dims."""
        if len(shape) != len(axes):
            raise ValueError(f"shape {tuple(shape)} vs logical axes {axes}")
        used: set[str] = set()
        out: list = []
        for size, logical in zip(shape, axes):
            assigned = None
            for cand in self.rules.get(logical, ()):
                flat = cand if isinstance(cand, tuple) else (cand,)
                if any(a in used or a not in self.mesh_axes for a in flat):
                    continue
                if size % self._axis_size(cand) != 0:
                    continue
                # 1-tuples become the bare axis name, as the reference's
                assigned = flat[0] if len(flat) == 1 else cand
                used.update(flat)
                break
            out.append(assigned)
        while out and out[-1] is None:
            out.pop()
        return P(*out)

    def shard_shape(self, shape: Sequence[int], spec) -> tuple[int, ...]:
        """One rank's block of a ``shape`` tensor laid out by ``spec``
        (``NamedSharding.shard_shape``); raises where a mapped dim does
        not divide."""
        out = []
        for d, size in enumerate(shape):
            n = self._axis_size(spec_axes(spec[d]) if d < len(spec) else ())
            if size % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                 f"divide over {spec[d]!r} ({n} ranks)")
            out.append(size // n)
        return tuple(out)

    def constrain(self, x, axes, *, shape=None):
        """Pin ``x``'s layout by logical axes: the identity on values, as
        ``with_sharding_constraint`` is.  The spec is taken at ``shape``
        (default ``x.shape``; a rank that holds only its rows passes the
        global shape), checked to divide, and counted in
        :attr:`constrained`."""
        shape = tuple(x.shape) if shape is None else tuple(shape)
        spec = self.spec(shape, axes)
        self.shard_shape(shape, spec)
        self.constrained[spec] += 1
        return x

    def tree_specs(self, params, param_axes):
        """Spec tree for a (params, axes) pair of trees (dicts of
        anything with ``.shape``, and twin dicts of axis tuples)."""
        if isinstance(params, dict):
            return {k: self.tree_specs(params[k], param_axes[k])
                    for k in params}
        if not _is_axes(param_axes):
            raise ValueError(f"not a logical-axes tuple: {param_axes!r}")
        return self.spec(tuple(params.shape), param_axes)


def slab_spec(mesh_axis: str | tuple) -> P:
    """PartitionSpec of a chunk-cyclic loop slab.

    Rank-1 slabs are ``(n_loc, P, c, *rest)`` over one mesh axis; a
    rank-2 nest over a 2-D mesh (``mesh_axis=("i", "j")``) parks its
    slabs as ``(n_i, P_i, c_i, n_j, P_j, c_j, *rest)`` — every third
    dim is a device axis.  The explicit-loop planner
    (:mod:`repro_torch.core.plan`) and the region residency planner
    (:mod:`repro_torch.core.region`) both park distributed buffers in
    this layout: the device dims make a "chunk-distributed array" an
    ordinary sharded tensor in the tensor-plan vocabulary — the bridge
    that lets loop-level residency compose with model-level sharding on
    one mesh.
    """
    if isinstance(mesh_axis, tuple):
        if len(mesh_axis) != 2:
            raise ValueError(
                f"slab_spec takes one axis or a 2-tuple, got {mesh_axis!r}")
        return P(None, mesh_axis[0], None, None, mesh_axis[1], None)
    return P(None, mesh_axis)


def _dp_axes(mesh_axes: tuple[str, ...]):
    return tuple(a for a in ("pod", "data") if a in mesh_axes)


def make_train_plan(mesh_axes, mesh_shape, *, zero3: bool = False,
                    strategy: str = "dp_tp") -> TensorPlan:
    """DP over (pod,data), TP/EP over model; ZeRO-3 adds param sharding
    over the data axes (gradients/optimizer state inherit it).

    ``strategy="dp_only"``: batch over EVERY axis (model included) and
    fully-sharded params over the same — the right layout for models too
    small/narrow to TP (gemma3's 4 heads on a 16-way model axis)."""
    dp = _dp_axes(mesh_axes)
    if strategy == "dp_only":
        all_axes = tuple(mesh_axes)
        rules = {
            BATCH: (all_axes, dp, "data"),
            # fully-sharded params (ZeRO-3 over the whole mesh)
            D_MODEL: (all_axes, dp, "data"),
            VOCAB: (all_axes, dp, "data"),
            D_FF: ("model",),
            D_INNER: ("model",),
            GROUPS: (all_axes, dp, "data"),
        }
        return TensorPlan(tuple(mesh_axes), tuple(mesh_shape), rules)
    rules = {
        BATCH: (dp, "data"),
        HEADS: ("model",),
        KV_HEADS: ("model",),
        D_FF: ("model",),
        D_EXPERT: ("model",),
        EXPERTS: ("model", ),
        VOCAB: ("model",),
        D_INNER: ("model",),
        D_STATE: ("model",),
        GROUPS: (dp, "data"),
        # SEQ: set by seq_parallel (Megatron-SP): residual activations
        # shard their sequence dim over the model axis between TP blocks,
        # turning each boundary all-reduce into reduce-scatter+all-gather
        # (half the bytes, spread over all links).
    }
    if zero3:
        # FSDP: the d_model dim of params shards over the data axes.
        rules[D_MODEL] = (dp, "data")
    return TensorPlan(tuple(mesh_axes), tuple(mesh_shape), rules)


def make_serve_plan(mesh_axes, mesh_shape, *, shard_seq: bool = False,
                    decode: bool = False) -> TensorPlan:
    """Inference plan. ``shard_seq`` (long_500k, batch=1): sequence/KV
    sharded over the data axes instead of batch (sequence parallelism)."""
    dp = _dp_axes(mesh_axes)
    rules = {
        BATCH: () if shard_seq else (dp, "data"),
        # KV caches shard their sequence dim: over everything available
        # in shard_seq mode (batch=1), over the model axis otherwise —
        # a batch-only-sharded 32k cache is 43 GB/chip on qwen1.5-110b;
        # attention over the sharded dim becomes flash-decoding-style
        # split-K with a psum combine.
        SEQ_KV: (dp + ("model",), dp, "model") if shard_seq
                else ("model",),
        SEQ: (dp, "data") if shard_seq else (),
        HEADS: ("model",),
        KV_HEADS: ("model",),
        # head_dim fallback (36H / 12H / kv=8 archs): contraction-sharded
        # attention with psum partials. DECODE ONLY — per-token scores are
        # tiny there; under chunked prefill/train attention the score-tile
        # psums explode (17.5 TB wire on starcoder2 prefill).
        HEAD_DIM: ("model",) if decode else (),
        # serve params also shard d_model over the data axes (weight-
        # resident would need 14 GB/chip on qwen1.5-110b); for decode the
        # partitioner reshards the tiny activations instead of gathering
        # weights, for prefill this is ZeRO-style gathering (compute-bound)
        D_MODEL: (dp, "data"),
        D_FF: ("model",),
        # expert weights shard 2D (experts x d_expert): one model-axis
        # shard of experts would keep a full d_model*d_expert per chip
        # (94 GB/chip on jamba long_500k)
        D_EXPERT: ("model", dp, "data"),
        EXPERTS: ("model",),
        VOCAB: ("model",),
        D_INNER: ("model",),
        D_STATE: ("model",),
        GROUPS: () if shard_seq else (dp, "data"),
    }
    return TensorPlan(tuple(mesh_axes), tuple(mesh_shape), rules)
