"""The model stack's entry to the kernels — counterpart of
:mod:`repro.kernels.ops`: it adapts the model's (B, S, H, hd) layout to
K2's (B, H, S, hd), and adds the ``D*x`` skip that K3 leaves out.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd


def flash_attention(q, k, v, *, kind="causal", window=None,
                    q_positions=None, k_positions=None):
    """Drop-in for ``repro_torch.models.layers.attention(impl="kernel")``.

    q: (B, S, H, hd); k, v: (B, Sk, KV, hd) — model-stack layout.  Like
    the reference's wrapper, it ignores explicit position arrays and
    aligns queries on the keys' suffix (query row i is position
    i + Sk - S).  In prefill the positions are 0..S-1 for both, so the
    two agree; a caller with other positions takes another path.  With
    ``kind="bidir"`` and no window (the encoder's self-attention, the
    decoder's cross-attention over the frames, S != Sk) every query sees
    every key, and the alignment plays no part.
    """
    del q_positions, k_positions
    out = fa.flash_attention(q.transpose(1, 2).contiguous(),
                             k.transpose(1, 2).contiguous(),
                             v.transpose(1, 2).contiguous(),
                             causal=(kind == "causal"), window=window)
    return out.transpose(1, 2)


def ssd_scan(x, dt, A, Bm, Cm, D, *, chunk=128):
    """Drop-in SSD scan: K3 plus the ``D*x`` skip the kernel omits, added
    in x's type as in the reference.

    x: (B, S, H, P); dt post-softplus; A negative; Bm/Cm (B, S, N);
    D (H,).  Strided inputs (the model's splits of one projection) are
    made contiguous for the kernel.
    """
    x = x.contiguous()
    y = ssd.ssd_scan_kernel(x, dt.contiguous(), A.contiguous(),
                            Bm.contiguous(), Cm.contiguous(), chunk=chunk)
    return y + x * D[:, None].to(x.dtype)
