"""AdamW with decoupled weight decay. State: (m, v, count)."""
from __future__ import annotations

import torch

from repro_torch.pytree import tree_leaves, tree_map, tree_unzip


def adamw_init(params):
    leaves = tree_leaves(params)
    return {
        "m": tree_map(torch.zeros_like, params),
        "v": tree_map(torch.zeros_like, params),
        "count": torch.zeros((), dtype=torch.int32,
                             device=leaves[0].device if leaves else "cpu"),
    }


@torch.no_grad()
def adamw_update(grads, state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1):
    count = state["count"] + 1
    c = count.float()
    bc1 = 1.0 - b1 ** c
    bc2 = 1.0 - b2 ** c

    def upd(g, m, v, p):
        g = g.float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * (g * g)
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        step = step + weight_decay * p.float()
        new_p = p.float() - lr * step
        return new_p.to(p.dtype), m, v

    new_p, new_m, new_v = tree_unzip(
        tree_map(upd, grads, state["m"], state["v"], params), 3)
    return new_p, {"m": new_m, "v": new_v, "count": count}
