#!/usr/bin/env python3
"""Show that K3's row check catches a fault its whole-tensor check passes.

    python3 tools/k3_planted_fault.py

Builds a copy of ``src/repro_torch/csrc/ssd_scan.cu`` in a temporary
directory (never in the checkout) with one planted fault: the state
entering every chunk past the 8th is scaled by 1.02.  Runs that K3 at
mamba2-130m's shape (B=2, S=4096, H=24, P=64, N=128, chunk 256: 16
chunks) in float32 and bfloat16 against the plain recurrence and prints,
per type, whether ``chip_smoke.agree`` (atol = tol x max|plain|) and
``chip_smoke.agree_rows`` (each row of P at tol x (|plain| + row RMS))
accept it.  Exits 0 when the row check rejects the fault in both types;
needs one CUDA card.
"""
from __future__ import annotations

import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FAULT = ("        s[(long)c * NP] = hcur;\n",
         "        s[(long)c * NP] = c >= 8 ? 1.02f * hcur : hcur;\n")


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    torch = cs._setup()
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ssd

    text = ssd.SOURCE.read_text()
    if text.count(FAULT[0]) != 1:
        raise SystemExit("k3_planted_fault: the state-scan line to plant "
                         "the fault in is not in ssd_scan.cu")
    print(f"card: {cs.card_line()}")
    rejected = True
    with tempfile.TemporaryDirectory() as tmp:
        mutant = Path(tmp) / "ssd_scan_fault.cu"
        mutant.write_text(text.replace(*FAULT))
        ssd._LIBRARY = _build.CudaLibrary(str(mutant), "K3-fault", ssd._bind)
        b, s, h, p, n, chunk = cs.ssm_shape()
        for dtype in (torch.float32, torch.bfloat16):
            tname = cs.dtname(dtype)
            tol = cs.K3_TOL[tname]
            args = cs.k3_inputs(torch, "cuda", b, s, h, p, n, dtype, 7)
            got = ssd.ssd_scan_kernel(*args, chunk=chunk).float()
            want = ssd.ssd_scan_plain(*args)[0].float()
            whole = cs.agree(torch, got, want, tol)
            rows = cs.agree_rows(torch, got, want, tol)
            rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
            worst = ((got - want).abs() / (want.abs() + rms)).max().item()
            err = (got - want).abs().max().item()
            print(f"K3 with the state past chunk 8 scaled by 1.02, {tname} "
                  f"(tol {tol}): max abs err {err:.3e} vs atol "
                  f"{tol * want.abs().max().item():.3e} -> agree "
                  f"{'passes' if whole else 'fails'}; worst row-relative "
                  f"err {worst:.3e} -> agree_rows "
                  f"{'passes' if rows else 'fails'}")
            rejected &= not rows
    return 0 if rejected else 1


if __name__ == "__main__":
    raise SystemExit(main())
