"""Shared layers: norms, RoPE, attention (four execution paths), MLP and
the chunked cross-entropy loss — counterpart of :mod:`repro.models.layers`.

Attention paths (``impl`` of :func:`attention`):

* ``full``    — materialised scores; small shapes and decode.
* ``chunked`` — online softmax over KV blocks (the flash recurrence in
  plain PyTorch, a Python loop over Q blocks of 2048 and KV blocks of
  1024): O(block) score memory.
* ``kernel``  — K2, the hand-written CUDA flash-attention kernel
  (:mod:`repro_torch.kernels.ops`); on CPU tensors its plain version.
  The counterpart of the reference's ``impl="pallas"``.
* ``auto``    — ``chunked`` when the full score tile would be large,
  else ``full``, as in the reference.

Parameter trees are built by :mod:`repro_torch.models.blocks`; every
parameter travels with its logical axes, as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import tensor_plan as tp

INT32_MAX = 2 ** 31 - 1


# ---------------------------------------------------------------------------
# Param helpers: params and their logical axes travel together
# ---------------------------------------------------------------------------


def make_param(gen: torch.Generator, shape, axes, scale=0.02,
               dtype=torch.float32):
    """A normal(0, scale) parameter drawn from ``gen``, on its device,
    with its logical axes."""
    w = torch.randn(tuple(shape), generator=gen, dtype=dtype,
                    device=gen.device)
    return w * scale, tuple(axes)


def zeros_param(shape, axes, dtype=torch.float32, device="cpu"):
    return torch.zeros(tuple(shape), dtype=dtype, device=device), tuple(axes)


def is_param_leaf(x) -> bool:
    """A ``(tensor, axes)`` pair of an init tree."""
    return isinstance(x, tuple) and len(x) == 2 and hasattr(x[0], "shape")


def split_tree(tree):
    """{(tensor, axes)} tree of dicts -> (params, axes) twin trees."""
    if is_param_leaf(tree):
        return tree
    params, axes = {}, {}
    for k, v in tree.items():
        params[k], axes[k] = split_tree(v)
    return params, axes


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, weight, eps=1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def layer_norm(x, weight, bias, eps=1e-6):
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight + bias).to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device="cpu"):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta):
    """x: (B, S, N, hd); positions: (B, S) int32."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = rope_freqs(hd, theta, x.device)              # (half,)
    angles = positions[..., None].float() * freqs        # (B,S,half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    rot1 = x1 * cos - x2 * sin
    rot2 = x2 * cos + x1 * sin
    out = torch.cat([rot1, rot2], dim=-1)
    if hd != 2 * half:  # odd head_dim tail passes through
        out = torch.cat([out, x[..., 2 * half:].to(out.dtype)], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


NEG_INF = -1e30


def _mask_bias(kind, window, q_pos, k_pos):
    """(..., Sq, Sk) additive bias from positions."""
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    if kind == "bidir":
        allowed = torch.ones(torch.broadcast_shapes(dq.shape, dk.shape),
                             dtype=torch.bool, device=q_pos.device)
    else:  # causal
        allowed = dk <= dq
    if window is not None:
        allowed = allowed & (dk > dq - window)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(allowed, zero, torch.full_like(zero, NEG_INF))


def _default_positions(positions, b, s, device):
    if positions is None:
        return torch.arange(s, dtype=torch.int32,
                            device=device).expand(b, s)
    return positions


def attention_full(q, k, v, *, kind="causal", window=None,
                   q_positions=None, k_positions=None):
    """Materialised-scores attention with GQA.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd).  positions: (B, S).
    """
    b, sq, h, hd = q.shape
    _, sk, kv, _ = k.shape
    g = h // kv
    q_positions = _default_positions(q_positions, b, sq, q.device)
    k_positions = _default_positions(k_positions, b, sk, q.device)
    qg = q.reshape(b, sq, kv, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          k.float()) / math.sqrt(hd)
    bias = _mask_bias(kind, window, q_positions, k_positions)  # (B,Sq,Sk)
    scores = scores + bias[:, None, None]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def attention_chunked(q, k, v, *, kind="causal", window=None,
                      q_positions=None, k_positions=None, block_kv=1024,
                      block_q=2048):
    """Online softmax (the flash recurrence): Q blocks x KV blocks, a
    Python loop over each.  Memory O(block_q * block_kv) score tiles
    instead of O(Sq * Sk).  Padded keys carry position INT32_MAX (masked
    for every query); padded queries are dropped.  A sequence shorter
    than one block is one block of its own length (the reference pads it
    to the block; padded rows and keys add exactly nothing)."""
    b, sq, h, hd = q.shape
    _, sk, kv, _ = k.shape
    g = h // kv
    q_positions = _default_positions(q_positions, b, sq, q.device)
    k_positions = _default_positions(k_positions, b, sk, q.device)
    block_kv = min(block_kv, sk)
    block_q = min(block_q, sq)
    nb = -(-sk // block_kv)
    pad = nb * block_kv - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_positions = F.pad(k_positions, (0, pad), value=INT32_MAX)
    nq = -(-sq // block_q)
    qpad = nq * block_q - sq
    if qpad:
        q = F.pad(q, (0, 0, 0, 0, 0, qpad))
        q_positions = F.pad(q_positions, (0, qpad), value=INT32_MAX - 1)

    def one_q_block(qblk, qpos):                       # (b,bq,h,hd)
        qg = qblk.reshape(b, block_q, kv, g, hd).float() / math.sqrt(hd)
        m = torch.full((b, kv, g, block_q), NEG_INF, device=q.device)
        l = torch.zeros((b, kv, g, block_q), device=q.device)
        acc = torch.zeros((b, block_q, kv, g, hd), device=q.device)
        for j in range(nb):
            sl = slice(j * block_kv, (j + 1) * block_kv)
            s = torch.einsum("bqkgd,bskd->bkgqs", qg, k[:, sl].float())
            s = s + _mask_bias(kind, window, qpos, k_positions[:, sl])[
                :, None, None]
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(m_new == NEG_INF, 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(s <= NEG_INF / 2, 0.0, p)
            corr = torch.exp(torch.where(m == NEG_INF, NEG_INF, m - m_safe))
            corr = torch.where(m == NEG_INF, 0.0, corr)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bqkgd", p, v[:, sl].float())
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        l = torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
        return (acc / l).reshape(b, block_q, h, hd)

    out = torch.cat([one_q_block(q[:, i * block_q:(i + 1) * block_q],
                                 q_positions[:, i * block_q:(i + 1) * block_q])
                     for i in range(nq)], dim=1)
    return out[:, :sq].to(q.dtype)


def attention_decode(q, k_cache, v_cache, *, window=None,
                     q_positions=None, k_positions=None):
    """Single-token decode attention over a (possibly padded) KV cache.

    q: (B, 1, H, hd); caches: (B, S, KV, hd); k_positions: (B, S) with
    unfilled slots marked by a huge position (masked out).
    """
    return attention_full(
        q, k_cache, v_cache, kind="causal", window=window,
        q_positions=q_positions, k_positions=k_positions)


def attention(q, k, v, *, kind="causal", window=None, q_positions=None,
              k_positions=None, impl="auto", block_kv=1024):
    if impl == "auto":
        # blocked path whenever the full score tile would be large
        impl = ("chunked" if q.shape[1] * k.shape[1] > 2048 * 2048
                else "full")
    if impl == "full":
        return attention_full(q, k, v, kind=kind, window=window,
                              q_positions=q_positions,
                              k_positions=k_positions)
    if impl == "chunked":
        return attention_chunked(q, k, v, kind=kind, window=window,
                                 q_positions=q_positions,
                                 k_positions=k_positions,
                                 block_kv=block_kv)
    if impl == "kernel":
        from repro_torch.kernels import ops as kops

        return kops.flash_attention(q, k, v, kind=kind, window=window,
                                    q_positions=q_positions,
                                    k_positions=k_positions)
    raise ValueError(f"unknown attention impl {impl!r} "
                     "(auto, full, chunked or kernel)")


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_apply(p, x, *, gated: bool):
    """SwiGLU (gated) or GELU MLP (tanh approximation, as ``jax.nn.gelu``
    defaults to). x: (..., D)."""
    dtype = x.dtype
    if gated:
        gate = x @ p["w_gate"].to(dtype)
        up = x @ p["w_up"].to(dtype)
        h = F.silu(gate) * up
    else:
        h = F.gelu(x @ p["w_up"].to(dtype), approximate="tanh")
    return h @ p["w_down"].to(dtype)


def init_mlp(gen, d_model, d_ff, *, gated: bool):
    t = {}
    if gated:
        t["w_gate"] = make_param(gen, (d_model, d_ff), (tp.D_MODEL, tp.D_FF))
    t["w_up"] = make_param(gen, (d_model, d_ff), (tp.D_MODEL, tp.D_FF))
    t["w_down"] = make_param(gen, (d_ff, d_model), (tp.D_FF, tp.D_MODEL))
    return t


# ---------------------------------------------------------------------------
# Loss: chunked cross-entropy (never materialises (B,S,V) logits)
# ---------------------------------------------------------------------------


def _ce_chunk(xc, w_head, lc, mc):
    """(sum of masked token CEs, masked token count) of one chunk, in
    float32."""
    logits = xc.float() @ w_head.float()
    lse = torch.logsumexp(logits, dim=-1)
    # the label logit (the reference contracts a one-hot, the same value,
    # so that a vocab-sharded head partitions; here it is gathered)
    ll = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
    tot = torch.where(mc, lse - ll, torch.zeros_like(lse)).sum()
    return tot, mc.sum(dtype=torch.float32)


def chunked_cross_entropy(x, w_head, labels, *, mask=None, chunk=512):
    """Mean CE over the tokens ``mask`` keeps. x: (B,S,D), w_head: (D,V),
    labels: (B,S).  Tokens are taken ``chunk`` positions at a time, each
    chunk's (B, chunk, V) logits recomputed in the backward pass
    (``torch.utils.checkpoint``) instead of kept, as the reference's
    checkpointed scan.  The last chunk is the remainder (the reference
    pads it to a whole chunk with masked tokens, which add nothing)."""
    tot, cnt = chunked_ce_sum(x, w_head, labels, mask=mask, chunk=chunk)
    return tot / torch.clamp(cnt, min=1.0)


def chunked_ce_sum(x, w_head, labels, *, mask=None, chunk=512):
    """(sum of the CEs of the tokens ``mask`` keeps, their count), both
    float32 scalars: :func:`chunked_cross_entropy` before its division."""
    from torch.utils.checkpoint import checkpoint

    b, s, _ = x.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.bool, device=x.device)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(0, s, chunk):
        sl = slice(j, j + chunk)
        t, c = checkpoint(_ce_chunk, x[:, sl], w_head, labels[:, sl],
                          mask[:, sl].bool(), use_reentrant=False)
        tot, cnt = tot + t, cnt + c
    return tot, cnt
