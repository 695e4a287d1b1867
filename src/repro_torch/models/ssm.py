"""Mamba-2 SSD (state-space duality) block — counterpart of
:mod:`repro.models.ssm`. [arXiv:2405.21060]

The sequence loop of an SSM is a loop-carried dependence; SSD's chunked
form makes the work inside a chunk a dense parallel product and leaves
only the recurrence over chunk states sequential (a Python loop over
chunks here, ``lax.scan`` in the reference).

Layout: x (B,S,D); heads h = d_inner/head_dim; one group of B/C of width
d_state shared by all heads.  :func:`ssd_chunked` is the model path, as
in the reference; K3 (``repro_torch.kernels.ops.ssd_scan``) computes the
same scan and is held against it on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import tensor_plan as tp
from repro_torch.models.layers import make_param


def init_ssm(gen: torch.Generator, d_model: int, ssm_cfg):
    din = ssm_cfg.d_inner(d_model)
    nh = ssm_cfg.n_heads(d_model)
    ds = ssm_cfg.d_state
    cw = ssm_cfg.d_conv
    dev = gen.device
    return {
        "w_z": make_param(gen, (d_model, din), (tp.D_MODEL, tp.D_INNER)),
        "w_x": make_param(gen, (d_model, din), (tp.D_MODEL, tp.D_INNER)),
        "w_B": make_param(gen, (d_model, ds), (tp.D_MODEL, tp.D_STATE)),
        "w_C": make_param(gen, (d_model, ds), (tp.D_MODEL, tp.D_STATE)),
        "w_dt": make_param(gen, (d_model, nh), (tp.D_MODEL, tp.HEADS)),
        "conv_x": make_param(gen, (cw, din), (tp.CONV, tp.D_INNER), 0.5),
        "conv_B": make_param(gen, (cw, ds), (tp.CONV, tp.D_STATE), 0.5),
        "conv_C": make_param(gen, (cw, ds), (tp.CONV, tp.D_STATE), 0.5),
        # A in (-16, -1): stable decay; dt_bias ~ softplus^-1(0.01..0.1)
        "A_log": (torch.log(torch.linspace(1.0, 16.0, nh, device=dev)),
                  (tp.HEADS,)),
        "D": (torch.ones((nh,), device=dev), (tp.HEADS,)),
        "dt_bias": (torch.full((nh,), -4.6, device=dev), (tp.HEADS,)),
    }


def _causal_conv(u, w, state=None):
    """Depthwise causal conv. u: (B,S,C), w: (cw,C).

    ``state`` ((B, cw-1, C)) prepends history for decode/continuation;
    returns (y, new_state)."""
    cw = w.shape[0]
    if state is None:
        state = torch.zeros((u.shape[0], cw - 1, u.shape[2]), dtype=u.dtype,
                            device=u.device)
    full = torch.cat([state, u], dim=1)                  # (B, S+cw-1, C)
    y = torch.zeros_like(u)
    for k in range(cw):
        y = y + full[:, k:k + u.shape[1]] * w[k]
    new_state = full[:, full.shape[1] - (cw - 1):]
    return y, new_state


def _segsum_decay(a):
    """a: (..., Q, h) cumulative dA. Returns exp(a_i - a_j) masked i>=j:
    (..., Q, Q, h)."""
    q = a.shape[-2]
    seg = a[..., :, None, :] - a[..., None, :, :]
    idx = torch.arange(q, device=a.device)
    mask = (idx[:, None] >= idx[None, :])[..., None]
    return torch.where(mask, torch.exp(seg), torch.zeros((), device=a.device))


def ssd_chunked(xh, dt, A, Bc, Cc, D, *, chunk: int, h0=None):
    """Chunked SSD scan.

    xh: (B,S,h,p); dt: (B,S,h) (post-softplus); A: (h,) negative;
    Bc, Cc: (B,S,s); D: (h,). Returns (y (B,S,h,p), h_final (B,h,p,s)).
    """
    b, s, h, p = xh.shape
    ds = Bc.shape[-1]
    q = chunk
    nc = -(-s // q)
    pad = nc * q - s
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bc = F.pad(Bc, (0, 0, 0, pad))
        Cc = F.pad(Cc, (0, 0, 0, pad))
    f32 = torch.float32
    xc = xh.reshape(b, nc, q, h, p).to(f32)
    dtc = dt.reshape(b, nc, q, h).to(f32)
    Bcc = Bc.reshape(b, nc, q, ds).to(f32)
    Ccc = Cc.reshape(b, nc, q, ds).to(f32)

    dA = dtc * A                                         # (b,nc,q,h) <= 0
    a = torch.cumsum(dA, dim=2)
    decay = _segsum_decay(a)                             # (b,nc,q,q,h)
    cb = torch.einsum("bcqs,bcks->bcqk", Ccc, Bcc)
    scores = cb[..., None] * decay * dtc[:, :, None]     # (b,nc,q,k,h)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", scores, xc)

    # per-chunk state contribution and total decay
    a_last = a[:, :, -1]                                 # (b,nc,h)
    w = torch.exp(a_last[:, :, None] - a) * dtc          # (b,nc,q,h)
    h_chunk = torch.einsum("bckh,bcks,bckhp->bchps", w, Bcc, xc)
    t_chunk = torch.exp(a_last)                          # (b,nc,h)

    hprev = (torch.zeros((b, h, p, ds), dtype=f32, device=xh.device)
             if h0 is None else h0.to(f32))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hprev)
        hprev = hprev * t_chunk[:, c, :, None, None] + h_chunk[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                # (b,nc,h,p,s)

    y_inter = torch.einsum("bcqs,bchps->bcqhp", Ccc, h_prevs) \
        * torch.exp(a)[..., None]
    y = (y_intra + y_inter + xc * D[:, None]).reshape(b, nc * q, h, p)
    return y[:, :s].to(xh.dtype), hprev


def ssm_apply(p, x, ssm_cfg, *, cache=None):
    """Full SSD block. x: (B,S,D) -> (y (B,S,D), new_cache).

    ``cache``: {"h": (B,h,p,s), "conv": (B,cw-1,din+2ds)} for decode /
    chunked prefill continuation; None for fresh sequences.
    """
    b, s, _ = x.shape
    dtype = x.dtype
    din = p["w_x"].shape[1]
    nh = p["w_dt"].shape[1]
    hd = din // nh
    ds = p["w_B"].shape[1]
    f32 = torch.float32

    def proj(w):
        return torch.einsum("bsd,dk->bsk", x, w.to(dtype))

    z = proj(p["w_z"])
    xin, Bin, Cin = proj(p["w_x"]), proj(p["w_B"]), proj(p["w_C"])
    dt = proj(p["w_dt"]) + p["dt_bias"].to(dtype)

    conv_w = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]],
                       dim=1).to(dtype)
    u = torch.cat([xin, Bin, Cin], dim=2)
    conv_state = None if cache is None else cache["conv"]
    u, new_conv = _causal_conv(u, conv_w, conv_state)
    u = F.silu(u)
    xin, Bin, Cin = torch.split(u, [din, ds, ds], dim=2)

    dt = F.softplus(dt.to(f32))
    A = -torch.exp(p["A_log"].to(f32))
    xh = xin.reshape(b, s, nh, hd)
    h0 = None if cache is None else cache["h"]

    if s == 1 and cache is not None:
        # decode: one recurrence step, no chunking
        dA = torch.exp(dt[:, 0] * A)                     # (b,h)
        upd = torch.einsum("bh,bs,bhp->bhps", dt[:, 0], Bin[:, 0].to(f32),
                           xh[:, 0].to(f32))
        h_new = h0 * dA[:, :, None, None] + upd
        y = torch.einsum("bs,bhps->bhp", Cin[:, 0].to(f32), h_new)
        y = y + xh[:, 0].to(f32) * p["D"][:, None]
        y = y[:, None].to(dtype)                         # (b,1,h,p)
        h_final = h_new
    else:
        y, h_final = ssd_chunked(xh, dt, A, Bin, Cin, p["D"].to(f32),
                                 chunk=ssm_cfg.chunk, h0=h0)

    y = y.reshape(b, s, din) * F.silu(z)
    out = torch.einsum("bsk,kd->bsd", y, p["out_proj"].to(dtype))
    return out, {"h": h_final, "conv": new_conv}


def init_ssm_block(gen: torch.Generator, d_model: int, ssm_cfg):
    t = init_ssm(gen, d_model, ssm_cfg)
    din = ssm_cfg.d_inner(d_model)
    t["out_proj"] = make_param(gen, (din, d_model), (tp.D_INNER, tp.D_MODEL))
    return t


def init_ssm_cache(batch: int, d_model: int, ssm_cfg, dtype=torch.bfloat16,
                   device="cpu"):
    din = ssm_cfg.d_inner(d_model)
    nh = ssm_cfg.n_heads(d_model)
    return {
        "h": torch.zeros((batch, nh, ssm_cfg.head_dim, ssm_cfg.d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, ssm_cfg.d_conv - 1,
                             din + 2 * ssm_cfg.d_state), dtype=dtype,
                            device=device),
    }
