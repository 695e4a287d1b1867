#!/usr/bin/env python3
"""K1's product kernels on one NVIDIA card against the variants that
two choices of the span-kernel generator set aside:

* a matrix that a product reads transposed (syrk's and syr2k's ``A.T``,
  covariance's rows) reaches the kernel as a copy of its transpose
  (``span_kernel.kernel_args``, kind ``"replT"``), against the kernel
  reading it as it lies in memory (along K);
* a matrix-vector span launches with ``span_kernel._MV_WARPS`` (2) warps
  a program, against 4;

and, at n = 512, the 16-bit route of a product (bfloat16 and float16
operands go to ``tl.dot`` as they are, with a float32 accumulator),
held against the plain version at 1e-2 (one bfloat16 rounding).

    python3 tools/k1_product_variants.py

PolyBench/C 4.2.1 EXTRALARGE dims, float32, 8 ranks, ``static`` — the
spans of ``chip_smoke.py``'s phase 17.  Each variant is held against the
plain version (``chip_smoke.agree`` at 1e-4), then the two are timed in
turns (chosen, other, other, chosen; CUDA events, ``chip_smoke.cuda_ms``
per launch, the transposed copy included).  Needs a CUDA card.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spans(torch, omp, pb, transform, name, dev):
    """``(program, plan, stage feeds)`` of every block of kernel
    ``name``, each block fed the env the earlier blocks left."""
    mesh = omp.make_mesh((8,), ("data",), device=dev)
    kernel = pb.make(name)
    env = kernel.env_fn(dev)
    out = []
    for prog in kernel.programs:
        comp = omp.compile(prog, mesh, lowering="collective",
                           schedule=omp.static(), env_like=env)
        repl, slabs = transform.stage_inputs(comp.plan, env)
        out.append((prog, comp.plan, [(slabs, repl)]))
        env = comp(env)
    return out


def timed(cs, torch, span_kernel, plan, prog, io, dev, sources, label):
    """Each source checked against the plain version on the lanes that
    hold an iteration, then timed in turns: a, b, b, a.  Returns the
    mean ms of each."""
    from repro_torch.core import kernel_lower

    want = span_kernel.span_values_plain(plan, prog, *io[0], dev)
    mask = kernel_lower.lane_mask(plan, dev)
    for src in sources:
        (got,) = span_kernel.launch_span(src, io, dev)
        for k in want:
            if not cs.agree(torch, got[k][mask], want[k][mask], 1e-4):
                raise AssertionError(f"{label} {src.fn_name}: != plain")
    a, b = sources
    ms = {0: [], 1: []}
    for i in (0, 1, 1, 0):
        src = (a, b)[i]
        ms[i].append(cs.cuda_ms(torch, lambda: span_kernel.launch_span(
            src, io, dev)))
    return sum(ms[0]) / 2, sum(ms[1]) / 2


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    torch = cs._setup()
    from repro_torch import omp
    from repro_torch import polybench as pb
    from repro_torch.core import transform
    from repro_torch.kernels import span_kernel

    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"card: {card}")
    gen = span_kernel._Gen
    as_copy = gen.__dict__["_k_contiguous"]
    for name, block in (("syrk", 0), ("syr2k", 0), ("covariance", 1)):
        prog, plan, io = spans(torch, omp, pb, transform, name, dev)[block]
        copy = span_kernel.generate(plan, prog, dev)
        gen._k_contiguous = staticmethod(lambda *a: False)
        try:
            as_lies = span_kernel.generate(plan, prog, dev)
        finally:
            gen._k_contiguous = as_copy
        assert any(k == "replT" for k, _, _ in copy.inputs)
        assert not any(k == "replT" for k, _, _ in as_lies.inputs)
        t_copy, t_lies = timed(cs, torch, span_kernel, plan, prog, io, dev,
                               (copy, as_lies), name)
        print(f"{name}/{prog.name}: transpose copied {t_copy:.4f} ms, read "
              f"as it lies {t_lies:.4f} ms ({t_lies / t_copy:.2f}x) on "
              f"{card}")
    for name, block in (("atax", 0), ("bicg", 0), ("mvt", 0),
                        ("gesummv", 0)):
        prog, plan, io = spans(torch, omp, pb, transform, name, dev)[block]
        src = span_kernel.generate(plan, prog, dev)
        four = dataclasses.replace(src, num_warps=4)
        t_mv, t_four = timed(cs, torch, span_kernel, plan, prog, io, dev,
                             (src, four), name)
        print(f"{name}/{prog.name}: {src.num_warps} warps {t_mv:.4f} ms, 4 "
              f"warps {t_four:.4f} ms ({t_four / t_mv:.2f}x) on {card}")
    from repro_torch.core import kernel_lower

    mesh = omp.make_mesh((8,), ("data",), device=dev)
    for name in ("gemm", "syrk", "atax"):
        kernel = pb.make(name, 512)
        prog = kernel.programs[0]
        for dt in (torch.bfloat16, torch.float16):
            env = {k: v.to(dt) for k, v in kernel.env_fn(dev).items()}
            comp = omp.compile(prog, mesh, lowering="collective",
                               schedule=omp.static(), env_like=env)
            repl, slabs = transform.stage_inputs(comp.plan, env)
            src = span_kernel.generate(comp.plan, prog, dev)
            if "tl.dot(" not in src.text or "ieee" in src.text:
                raise AssertionError(f"{name} {dt}: not a 16-bit tl.dot")
            (got,) = span_kernel.launch_span(src, [(slabs, repl)], dev)
            want = span_kernel.span_values_plain(comp.plan, prog, slabs,
                                                 repl, dev)
            mask = kernel_lower.lane_mask(comp.plan, dev)
            for k in want:
                g, w = got[k][mask].float(), want[k][mask].float()
                if not cs.agree(torch, g, w, 1e-2):
                    raise AssertionError(f"{name} {dt} {k}: != plain")
                print(f"{name}/{prog.name} {dt}: 16-bit tl.dot == plain at "
                      f"1e-2, max abs err {(g - w).abs().max().item():.3e} "
                      f"of max {w.abs().max().item():.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
