"""Gradient utilities: global-norm clipping and int8 error-feedback
compression (each worker quantises its gradient to int8 with a
per-tensor scale and keeps the quantisation error as feedback added to
the next step's gradient).
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
