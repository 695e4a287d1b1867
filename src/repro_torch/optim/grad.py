"""Gradient utilities: global-norm clipping, int8 error-feedback
compression (each worker quantises its gradient to int8 with a
per-tensor scale and keeps the quantisation error as feedback added to
the next step's gradient) and the compressed all-reduce built on it,
over the ranks of the stacked mesh (:class:`repro_torch.mesh.Mesh`).
"""
from __future__ import annotations

import torch

from repro_torch.pytree import tree_leaves, tree_map, tree_unzip


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in tree_leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled so its global norm is at most ``max_norm``, the norm
    before)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


@torch.no_grad()
def compress_int8(g, error):
    """Quantise g+error to int8 with a per-tensor scale.

    Returns (q, scale, new_error)."""
    gf = g.float() + error
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, gf - deq


def decompress_int8(q, scale):
    return q.float() * scale


def tree_compress_int8(grads, errors):
    """Error-feedback int8 compression leaf by leaf.

    Returns (q_tree, scale_tree, new_error_tree)."""
    return tree_unzip(tree_map(compress_int8, grads, errors), 3)


def tree_decompress_int8(qs, scales):
    return tree_map(decompress_int8, qs, scales)


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


# ---------------------------------------------------------------------------
# Compressed all-reduce over the stacked mesh
# ---------------------------------------------------------------------------


def _compress_ranks(gf, err):
    """:func:`compress_int8` of every rank's row of ``gf + err`` (P, n),
    each with its own scale: (q (P, n) int8, scale (P,), new error)."""
    gf = gf + err
    scale = torch.clamp(torch.amax(torch.abs(gf), dim=1), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale[:, None]), -127, 127).to(
        torch.int8)
    return q, scale, gf - q.float() * scale[:, None]


@torch.no_grad()
def _compressed_allreduce_leaf(g, err, mesh, axis):
    """Two-hop int8 mean of the per-rank ``g`` (P, ...) over ``axis``:
    quantise -> all_to_all int8 slices -> local segment mean ->
    re-quantise -> all_gather int8.  Returns (the mean, every rank's
    alike, shaped as one rank's ``g``; the new errors (P, ...)).

    Wire ~ S/4 + S/4 int8 bytes vs ~2S fp32 for a ring all-reduce: ~4x.
    Error feedback makes the long-run average exact."""
    p = mesh.shape[axis]
    flat = g.reshape(p, -1).float()
    n = flat.shape[1]
    k = -(-n // p)
    pad = p * k - n
    err_f = err.reshape(p, -1).float()
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
        err_f = torch.nn.functional.pad(err_f, (0, pad))
    q, scale, new_err = _compress_ranks(flat, err_f)
    recv = mesh.all_to_all(q.reshape(p, p, 1, k), axis, 0, 0)[:, :, 0]
    scales = mesh.all_gather(scale, axis)                     # (P,)
    seg_mean = torch.sum(recv.float() * scales[None, :, None],
                         dim=1) / p                           # (P, k)
    q2, scale2, _ = _compress_ranks(seg_mean, torch.zeros_like(seg_mean))
    all_q2 = mesh.all_gather(q2, axis)                        # (P, k) int8
    all_s2 = mesh.all_gather(scale2, axis)                    # (P,)
    full = (all_q2.float() * all_s2[:, None]).reshape(-1)[:n]
    return (full.reshape(g.shape[1:]).to(g.dtype),
            new_err[:, :n].reshape(g.shape))


def compressed_allreduce_tree(grads, errors, *, mesh, axis: str):
    """int8 error-feedback gradient mean across ``axis`` of ``mesh``.

    ``grads`` and ``errors`` hold every rank's tensor stacked over a
    leading rank dim (P, ...); returns (the mean tree, one tensor per
    leaf as every rank receives it; the new error tree (P, ...)).  Its
    counted bytes (``mesh.bytes``: one ``all_to_all`` and three
    ``all_gather`` a leaf) are ~1/4 of a float ``psum``'s."""
    return tree_unzip(tree_map(
        lambda g, e: _compressed_allreduce_leaf(g, e, mesh, axis),
        grads, errors), 2)
