"""Mixture-of-Experts FFN with capacity-based token dispatch — the
counterpart of :mod:`repro.models.moe`.

Tokens are the loop iterations and experts the workers (the paper's
``schedule(dynamic)``); the capacity factor bounds the imbalance when
the router's "schedule" is skewed.  Dispatch runs per *group* (one
data-parallel shard's tokens), so the gather and scatter stay local to
the group and only the expert products touch every expert's weights.

The reference's semantics, op for op: the router's softmax in float32,
top-k with renormalised gates; each expert's capacity ``max(1, int(k *
tokens * capacity_factor / e))``, a token's slot in it given by a
cumulative sum in token order, so the later tokens over capacity drop;
the ``(E, C)`` dispatch table with invalid slots (gathered with
``index_select``, combined back with ``index_add_`` where the reference
scatters with ``.at[].add(mode="drop")``); padded experts (``e_alloc >
n_experts``) get ``-1e9`` logits and are never routed; the Switch
load-balance aux loss and the dropped share; the shared experts with
their sigmoid gate (qwen2-moe) and the dense FFN residual (arctic).

The expert products are batched matrix products (``torch.einsum``), as
the reference leaves them to XLA outside any Pallas kernel.  The two
profiler ranges ``moe.dispatch`` and ``moe.experts`` name where the time
goes (``torch.profiler.record_function``; nothing is recorded while no
profiler runs).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import tensor_plan as tp
from repro_torch.models.layers import init_mlp, make_param, mlp_apply

#: When a list, every :func:`moe_apply` call appends its groups' routing,
#: ``(G, T, E)`` int8 — per token and expert 0 (not chosen), 1 (chosen,
#: dropped over capacity) or 2 (chosen and kept) — in call order (one
#: entry per MoE layer of a forward pass): how a caller compares the
#: routing of two runs.  None: nothing is kept.
ROUTES: list | None = None


def init_moe(gen: torch.Generator, d_model: int, moe_cfg):
    e, fe = moe_cfg.e_alloc, moe_cfg.d_expert
    t = {
        "router": make_param(gen, (d_model, moe_cfg.n_experts),
                             (tp.D_MODEL, tp.EXPERTS)),
        "w_gate": make_param(gen, (e, d_model, fe),
                             (tp.EXPERTS, tp.D_MODEL, tp.D_EXPERT)),
        "w_up": make_param(gen, (e, d_model, fe),
                           (tp.EXPERTS, tp.D_MODEL, tp.D_EXPERT)),
        "w_down": make_param(gen, (e, fe, d_model),
                             (tp.EXPERTS, tp.D_EXPERT, tp.D_MODEL)),
    }
    if moe_cfg.n_shared:
        t["shared"] = init_mlp(gen, d_model, moe_cfg.shared_d_ff, gated=True)
        t["shared_gate"] = make_param(gen, (d_model, 1), (tp.D_MODEL, None))
    if moe_cfg.dense_residual_d_ff:
        t["dense"] = init_mlp(gen, d_model, moe_cfg.dense_residual_d_ff,
                              gated=True)
    return t


def _dispatch_one_group(x, logits, top_k: int, capacity: int):
    """x: (T, D), logits: (T, E) -> (gathered (E, C, D), table (E, C),
    slot_valid (E, C), w_slot (E, C), aux, dropped, routing (T, E): 0 not
    chosen, 1 dropped, 2 kept)."""
    t = x.shape[0]
    e = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    gate_idx = torch.topk(probs, top_k, dim=-1).indices          # (T, k)

    mask = F.one_hot(gate_idx, e).sum(1).to(torch.int32)        # (T, E)
    # each token's position in its expert's capacity buffer
    pos = torch.cumsum(mask, dim=0, dtype=torch.int32) * mask - 1
    keep = (pos >= 0) & (pos < capacity)

    # token ids into the (E, C) table; a dropped pair writes the spare
    # column C, cut off after (the reference's mode="drop")
    tok_ids = torch.arange(t, device=x.device, dtype=torch.int32)
    pos_safe = torch.where(keep, pos, torch.full_like(pos, capacity))
    table = torch.full((e, capacity + 1), t, dtype=torch.int32,
                       device=x.device)
    flat_e = torch.arange(e, device=x.device).expand(t, e)
    table[flat_e.reshape(-1), pos_safe.reshape(-1).long()] = \
        tok_ids[:, None].expand(t, e).reshape(-1)
    table = table[:, :capacity]
    slot_valid = table < t                                      # (E, C)
    table_safe = torch.clamp(table, max=t - 1).long()

    gathered = x.index_select(0, table_safe.reshape(-1)).view(
        e, capacity, -1) * slot_valid[..., None].to(x.dtype)

    # combine weights per slot
    w_tok = probs * (mask * keep).float()                       # (T, E)
    w_tok = w_tok / torch.clamp(w_tok.sum(-1, keepdim=True), min=1e-9)
    w_slot = w_tok[table_safe, torch.arange(e, device=x.device)[:, None]] \
        * slot_valid.float()                                    # (E, C)

    # load-balance aux (Switch): E * sum_e(frac_tokens_e * mean_prob_e)
    frac = mask.float().mean(0)
    mean_p = probs.mean(0)
    aux = e * torch.sum(frac * mean_p)
    dropped = 1.0 - keep.sum() / torch.clamp(mask.sum(), min=1)
    route = (mask * (1 + keep.to(torch.int32))).to(torch.int8)
    return gathered, table_safe, slot_valid, w_slot, aux, dropped, route


def moe_apply(p, x, moe_cfg, *, groups: int = 1):
    """x: (B, S, D) -> (y, aux_loss).  ``groups`` = data-parallel
    shards: dispatch is local to each group (see the module docstring)."""
    b, s, d = x.shape
    g = max(1, min(groups, b)) if b % max(1, min(groups, b)) == 0 else 1
    xt = x.reshape(g, (b // g) * s, d)
    tokens = xt.shape[1]
    e, k = moe_cfg.n_experts, moe_cfg.top_k
    capacity = max(1, int(k * tokens * moe_cfg.capacity_factor / e))

    logits = torch.einsum("gtd,de->gte", xt, p["router"].to(x.dtype))
    if moe_cfg.e_alloc > e:
        # padded (never routed) experts
        pad = torch.full(logits.shape[:-1] + (moe_cfg.e_alloc - e,), -1e9,
                         dtype=logits.dtype, device=x.device)
        logits = torch.cat([logits, pad], dim=-1)

    ys, auxes, routes = [], [], []
    w_gate, w_up = p["w_gate"].to(x.dtype), p["w_up"].to(x.dtype)
    w_down = p["w_down"].to(x.dtype)
    for xg, lg in zip(xt, logits):
        with torch.profiler.record_function("moe.dispatch"):
            gathered, table, _, w_slot, aux, _, route = _dispatch_one_group(
                xg, lg, k, capacity)
        with torch.profiler.record_function("moe.experts"):
            h_gate = torch.einsum("ecd,edf->ecf", gathered, w_gate)
            h_up = torch.einsum("ecd,edf->ecf", gathered, w_up)
            out = torch.einsum("ecf,efd->ecd", F.silu(h_gate) * h_up, w_down)
        with torch.profiler.record_function("moe.dispatch"):
            out = out * w_slot[..., None].to(x.dtype)
            y = torch.zeros_like(xg).index_add_(0, table.reshape(-1),
                                                out.reshape(-1, d))
        ys.append(y)
        auxes.append(aux)
        routes.append(route)
    if ROUTES is not None:
        ROUTES.append(torch.stack(routes))
    y = torch.stack(ys).reshape(b, s, d)
    aux_loss = torch.stack(auxes).mean()

    if "shared" in p:
        gate = torch.sigmoid(torch.einsum("bsd,do->bso", x,
                                          p["shared_gate"].to(x.dtype)))
        y = y + gate * mlp_apply(p["shared"], x, gated=True)
    if "dense" in p:
        y = y + mlp_apply(p["dense"], x, gated=True)
    return y, aux_loss
