"""Adafactor (Shazeer & Stern, 2018): factored second moment.

For a (r, c) matrix the second-moment estimate is stored as a rank-1
outer product of row/col statistics — O(r + c) instead of O(r*c).  >=2D
params factor over the two largest dims; 1D params keep a full second
moment.  Momentum is optional bf16 (off by default).
"""
from __future__ import annotations

import torch

from repro_torch.pytree import tree_leaves, tree_map, tree_unzip


def _factored_dims(shape):
    """Sorted indices of the two largest dims (factored), None for <2D."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])
    return tuple(sorted(order[-2:]))


def adafactor_init(params, *, momentum: bool = False):
    def per_param(p):
        dims = _factored_dims(p.shape)
        f32 = dict(dtype=torch.float32, device=p.device)
        if dims is None:
            st = {"v": torch.zeros(p.shape, **f32)}
        else:
            d0, d1 = dims                       # d0 < d1
            row_shape = tuple(s for i, s in enumerate(p.shape) if i != d1)
            col_shape = tuple(s for i, s in enumerate(p.shape) if i != d0)
            st = {"vr": torch.zeros(row_shape, **f32),
                  "vc": torch.zeros(col_shape, **f32)}
        if momentum:
            st["m"] = torch.zeros(p.shape, dtype=torch.bfloat16,
                                  device=p.device)
        return st

    leaves = tree_leaves(params)
    return {"per_param": tree_map(per_param, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=leaves[0].device if leaves
                                 else "cpu")}


@torch.no_grad()
def adafactor_update(grads, state, params, *, lr, decay=0.8, eps=1e-30,
                     clip_threshold=1.0, weight_decay=0.0,
                     momentum_beta=0.9, stream_leading: int = 0):
    """``stream_leading`` (0: off): >=3D params with a leading dim of at
    least this value update one leading slice at a time (the same math:
    the factored dims are never the leading one)."""
    count = state["count"] + 1
    c = count.float()
    beta2 = 1.0 - c ** (-decay)

    def upd_block(g, st, p, dims):
        """One (possibly sliced) block; dims are the factored axes."""
        g = g.float()
        g2 = g * g + eps
        if dims is None:
            v = beta2 * st["v"] + (1 - beta2) * g2
            new_st = {"v": v}
            update = g * torch.rsqrt(v)
        else:
            d0, d1 = dims                       # d0 < d1
            vr = beta2 * st["vr"] + (1 - beta2) * g2.mean(dim=d1)
            vc = beta2 * st["vc"] + (1 - beta2) * g2.mean(dim=d0)
            new_st = {"vr": vr, "vc": vc}
            # update = g / (sqrt(vr / mean_d0(vr)) (x) sqrt(vc))
            denom = vr.mean(dim=d0, keepdim=True)
            row_factor = torch.rsqrt(
                torch.clamp(vr / torch.clamp(denom, min=eps), min=eps))
            col_factor = torch.rsqrt(torch.clamp(vc, min=eps))
            update = (g * row_factor.unsqueeze(d1)
                      * col_factor.unsqueeze(d0))
        # update clipping (RMS <= clip_threshold)
        rms = torch.sqrt(torch.mean(update * update) + 1e-30)
        update = update / torch.clamp(rms / clip_threshold, min=1.0)
        if "m" in st:
            m = momentum_beta * st["m"].float() + (1 - momentum_beta) * update
            new_st["m"] = m.to(torch.bfloat16)
            update = m
        new_p = p.float() - lr * update - lr * weight_decay * p.float()
        return new_p.to(p.dtype), new_st

    def upd(g, st, p):
        dims = _factored_dims(p.shape)
        stream = (stream_leading and p.dim() >= 3 and dims is not None
                  and 0 not in dims and p.shape[0] >= stream_leading)
        if not stream:
            return upd_block(g, st, p, dims)
        sliced = tuple(d - 1 for d in dims)
        outs = [upd_block(g[i], {k: v[i] for k, v in st.items()}, p[i],
                          sliced) for i in range(p.shape[0])]
        return (torch.stack([o[0] for o in outs]),
                {k: torch.stack([o[1][k] for o in outs]) for k in outs[0][1]})

    new_p, new_s = tree_unzip(_map_states(upd, grads, state["per_param"],
                                          params), 2)
    return new_p, {"per_param": new_s, "count": count}


def _map_states(fn, grads, states, params):
    """``fn(g, state, p)`` per parameter: ``states`` has a dict of state
    tensors where ``params`` has a leaf."""
    if isinstance(params, dict):
        return {k: _map_states(fn, grads[k], states[k], params[k])
                for k in params}
    return fn(grads, states, params)
