"""Transformer blocks and the layer-interleave structure — counterpart of
:mod:`repro.models.blocks`, for the attention kinds (self-attention,
causal or bidirectional, and the encoder-decoder's cross-attention), the
SSM mixer and the dense and MoE FFNs (:mod:`repro_torch.models.moe`).

A heterogeneous stack (gemma3's 5:1 local:global interleave, jamba's
1:7 attention:SSM interleave with an MoE FFN every other layer) is a
repeating *period* of block kinds; the model loops over periods (params
stacked over a leading LAYERS dim) and then over the remainder.  A block
kind is the string "<mixer>:<flavour>:<ffn>", e.g. "attn:global:dense".
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import tensor_plan as tp
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    INT32_MAX,
    apply_rope,
    attention,
    init_mlp,
    make_param,
    mlp_apply,
    rms_norm,
    zeros_param,
)

INVALID_POS = INT32_MAX


def not_ported(what: str, module: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs {module}, which the PyTorch port does not have yet")


# ---------------------------------------------------------------------------
# Period structure
# ---------------------------------------------------------------------------


def kind_of_layer(cfg, idx: int) -> str:
    mixer = cfg.layer_kind(idx)                 # "attn" | "ssm"
    flavour = cfg.attn_kind(idx) if mixer == "attn" else ""
    if cfg.d_ff == 0 and cfg.moe is None:
        ffn = "none"                            # mamba2: SSD block only
    else:
        ffn = cfg.ffn_kind(idx)                 # "dense" | "moe"
    return f"{mixer}:{flavour}:{ffn}"


def period_structure(cfg):
    """Returns (period_len, slot_kinds, n_periods, tail_kinds)."""
    p = 1
    if cfg.attn_layer_period:
        p = math.lcm(p, cfg.attn_layer_period)
    if cfg.local_global_period:
        p = math.lcm(p, cfg.local_global_period)
    if cfg.moe is not None:
        p = math.lcm(p, cfg.moe.period)
    p = min(p, cfg.n_layers)
    n_periods = cfg.n_layers // p
    tail_start = n_periods * p
    slot_kinds = [kind_of_layer(cfg, i) for i in range(p)]
    tail_kinds = [kind_of_layer(cfg, i) for i in range(tail_start,
                                                       cfg.n_layers)]
    # kinds must repeat exactly across periods for stacking to be valid
    for layer in range(tail_start):
        assert kind_of_layer(cfg, layer) == slot_kinds[layer % p], (
            cfg.name, layer)
    return p, slot_kinds, n_periods, tail_kinds


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_attn(gen, cfg, *, cross: bool = False):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = gen.device
    t = {
        "norm": zeros_param((d,), (tp.D_MODEL,), device=dev),
        "wq": make_param(gen, (d, h, hd), (tp.D_MODEL, tp.HEADS,
                                           tp.HEAD_DIM)),
        "wk": make_param(gen, (d, kv, hd), (tp.D_MODEL, tp.KV_HEADS,
                                            tp.HEAD_DIM)),
        "wv": make_param(gen, (d, kv, hd), (tp.D_MODEL, tp.KV_HEADS,
                                            tp.HEAD_DIM)),
        "wo": make_param(gen, (h, hd, d), (tp.HEADS, tp.HEAD_DIM,
                                           tp.D_MODEL)),
    }
    if cfg.qkv_bias and not cross:
        t["bq"] = zeros_param((h, hd), (tp.HEADS, tp.HEAD_DIM), device=dev)
        t["bk"] = zeros_param((kv, hd), (tp.KV_HEADS, tp.HEAD_DIM),
                              device=dev)
        t["bv"] = zeros_param((kv, hd), (tp.KV_HEADS, tp.HEAD_DIM),
                              device=dev)
    return t


def init_ffn(gen, cfg, kind_ffn: str):
    if kind_ffn == "none":
        return None
    t = {"norm": zeros_param((cfg.d_model,), (tp.D_MODEL,),
                             device=gen.device)}
    if kind_ffn == "moe":
        t.update(moe_mod.init_moe(gen, cfg.d_model, cfg.moe))
    else:
        t.update(init_mlp(gen, cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp))
    return t


def init_block(gen, cfg, kind: str, *, with_cross: bool = False):
    mixer, _, ffn = kind.split(":")
    t: dict = {}
    if mixer == "attn":
        t["attn"] = init_attn(gen, cfg)
    else:
        t["ssm"] = {"norm": zeros_param((cfg.d_model,), (tp.D_MODEL,),
                                        device=gen.device),
                    **ssm_mod.init_ssm_block(gen, cfg.d_model, cfg.ssm)}
    if with_cross:
        t["cross"] = init_attn(gen, cfg, cross=True)
    f = init_ffn(gen, cfg, ffn)
    if f is not None:
        t["ffn"] = f
    return t


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------


def attn_cache_len(cfg, kind: str, cache_len: int) -> int:
    _, flavour, _ = kind.split(":")
    if flavour == "local" and cfg.sliding_window:
        return min(cfg.sliding_window, cache_len)
    return cache_len


def init_block_cache(cfg, kind: str, batch: int, cache_len: int,
                     dtype=torch.bfloat16, device="cpu"):
    mixer, _, _ = kind.split(":")
    if mixer == "ssm":
        return ssm_mod.init_ssm_cache(batch, cfg.d_model, cfg.ssm, dtype,
                                      device)
    length = attn_cache_len(cfg, kind, cache_len)
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, length, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, length, kv, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, length), INVALID_POS, dtype=torch.int32,
                          device=device),
    }


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def _project_qkv(p, x, cfg, *, rope_positions=None):
    dtype = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dtype))
    if "bq" in p:
        q = q + p["bq"].to(dtype)
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    if rope_positions is not None:
        q = apply_rope(q, rope_positions, cfg.rope_theta)
        k = apply_rope(k, rope_positions, cfg.rope_theta)
    return q, k, v


def _scatter(buf, index, values):
    """``buf`` with ``buf[index] = values``, as a new tensor (the
    reference's ``.at[].set``: the caller's cache is left as it was)."""
    out = buf.clone()
    out[index] = values.to(buf.dtype)
    return out


def attn_apply(p, x, cfg, kind: str, *, positions, cache=None,
               decode_pos=None, impl="auto", attn_mode="causal"):
    """Self-attention sub-block. Returns (out, new_cache).  Without a
    cache ``attn_mode`` is "causal" or "bidir" (the encoder's; rope still
    turns q and k by their positions)."""
    _, flavour, _ = kind.split(":")
    window = cfg.sliding_window if flavour == "local" else None
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v = _project_qkv(p, h, cfg, rope_positions=positions)

    if cache is None:
        out = attention(q, k, v, kind=attn_mode, window=window,
                        q_positions=positions, k_positions=positions,
                        impl=impl)
        new_cache = None
    elif decode_pos is None:
        # prefill: write KV at ring slots (pos % length) so a later
        # decode step's slot arithmetic stays consistent
        length = cache["k"].shape[1]
        s = k.shape[1]
        take = min(s, length)
        slots = (positions[:, s - take:] % length).long()   # (B, take)
        bidx = torch.arange(x.shape[0], device=x.device)[:, None]
        new_cache = {
            "k": _scatter(cache["k"], (bidx, slots), k[:, s - take:]),
            "v": _scatter(cache["v"], (bidx, slots), v[:, s - take:]),
            "pos": _scatter(cache["pos"], (bidx, slots),
                            positions[:, s - take:]),
        }
        out = attention(q, k, v, kind="causal", window=window,
                        q_positions=positions, k_positions=positions,
                        impl=impl)
    else:
        # decode: write this token's KV at its ring slot and attend to all
        length = cache["k"].shape[1]
        slot = (decode_pos % length).long()                # (B,)
        bidx = torch.arange(x.shape[0], device=x.device)
        new_cache = {
            "k": _scatter(cache["k"], (bidx, slot), k[:, 0]),
            "v": _scatter(cache["v"], (bidx, slot), v[:, 0]),
            "pos": _scatter(cache["pos"], (bidx, slot), decode_pos),
        }
        out = attention(q, new_cache["k"].to(q.dtype),
                        new_cache["v"].to(q.dtype), kind="causal",
                        window=window, q_positions=positions,
                        k_positions=new_cache["pos"], impl="full")
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return out, new_cache


def cross_attn_apply(p, x, enc_kv, cfg, *, impl="auto"):
    """Cross-attention against precomputed encoder K/V ``enc_kv``
    ((B, F, KV, hd) each): every query sees every frame, no positions."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    dtype = x.dtype
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"].to(dtype))
    k, v = enc_kv
    out = attention(q, k.to(dtype), v.to(dtype), kind="bidir", impl=impl)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dtype))


def ffn_apply(p, x, cfg, kind: str):
    """Returns (out, aux_loss)."""
    _, _, ffn = kind.split(":")
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn == "none" or "ffn" not in p:
        return torch.zeros_like(x), zero
    fp = p["ffn"]
    h = rms_norm(x, fp["norm"], cfg.norm_eps)
    if ffn == "moe":
        return moe_mod.moe_apply(fp, h, cfg.moe)
    return mlp_apply(fp, h, gated=cfg.gated_mlp), zero


def block_apply(p, x, cfg, kind: str, *, positions, cache=None,
                decode_pos=None, impl="auto", enc_kv=None,
                attn_mode="causal"):
    """One full block: mixer + (optional cross) + FFN, residual-wired.

    Returns (x, new_cache, aux_loss)."""
    mixer, _, ffn = kind.split(":")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mixer == "attn":
        out, new_cache = attn_apply(p["attn"], x, cfg, kind,
                                    positions=positions, cache=cache,
                                    decode_pos=decode_pos, impl=impl,
                                    attn_mode=attn_mode)
    else:
        h = rms_norm(x, p["ssm"]["norm"], cfg.norm_eps)
        sp = {k: v for k, v in p["ssm"].items() if k != "norm"}
        out, new_cache = ssm_mod.ssm_apply(sp, h, cfg.ssm, cache=cache)
    x = x + out
    if enc_kv is not None and "cross" in p:
        x = x + cross_attn_apply(p["cross"], x, enc_kv, cfg, impl=impl)
    if ffn != "none":
        out, aux = ffn_apply(p, x, cfg, kind)
        x = x + out
    return x, new_cache, aux
