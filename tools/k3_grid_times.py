#!/usr/bin/env python3
"""K3's five grids, timed apart, at mamba2-130m's shape.

    python3 tools/k3_grid_times.py

Builds ``src/repro_torch/csrc/ssd_scan.cu`` (``repro_torch.kernels.
ssd_scan``), holds it against its plain version at mamba2-130m's shape
(B=2, S=4096, H=24, P=64, N=128, chunk 256) in float32 and bfloat16
(``chip_smoke``'s ``hold``/``hold_rows`` at ``K3_TOL``), then prints per
type the time of one call (CUDA events, back to back) and the device
time of each grid (cumsum, chunk state, C.B^T, state scan, output) under
``torch.profiler``, with the card's name and power limit.  Needs one
CUDA card.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    torch = cs._setup()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ssd_scan as ssd

    dev = torch.device("cuda")
    card = cs.card_line()
    b, s, h, p, n, chunk = cs.ssm_shape()
    for dtype in (torch.float32, torch.bfloat16):
        tname = cs.dtname(dtype)
        args = cs.k3_inputs(torch, dev, b, s, h, p, n, dtype, 7)
        got = ssd.ssd_scan_kernel(*args, chunk=chunk)
        want = ssd.ssd_scan_plain(*args)[0]
        cs.hold(torch, got, want, cs.K3_TOL[tname], f"K3 {tname}")
        cs.hold_rows(torch, got, want, cs.K3_TOL[tname], f"K3 {tname}")
        ms = cs.cuda_ms(torch, lambda: ssd.ssd_scan_kernel(*args,
                                                           chunk=chunk))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                ssd.ssd_scan_kernel(*args, chunk=chunk)
            torch.cuda.synchronize()
        grids = [(e.key.split("::")[-1].split("(")[0].split("<")[0],
                  e.self_device_time_total / e.count / 1e3)
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.count
                 and "ssd_" in e.key]
        print(f"K3 {tname} B={b} S={s} H={h} P={p} N={n} chunk={chunk}: "
              f"{ms:.4f} ms a call; grids "
              + ", ".join(f"{k} {t:.4f}" for k, t in grids)
              + f" ms on {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
