#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and exits
non-zero (no phase catches an error and carries on):

1. **card** — the card's name and power limit (``nvidia-smi``), torch and
   triton versions;
2. **build** — each program of phase 3 compiled with
   ``lowering="kernel"``: its span kernels generated from the loop body,
   written under ``build/span_kernels/`` and JIT-built by Triton at
   first launch (timed together);
3. **programs** — the main path through ``omp.compile`` / ``Compiled.run``
   at PolyBench/C 4.2.1 EXTRALARGE scale or above, float32, each under
   ``lowering="collective"`` and ``lowering="kernel"``, held against
   ``run_reference`` on the card (rtol=atol=1e-4), with the span kernel's
   launch counter read around each kernel run:

   - ``pi``: the paper's Table 1 fill ``sum[i] = 4/(1+x²)`` and its ``+``
     reduction, two blocks, N = 2^24, 8 ranks;
   - ``jacobi1d``: one 3-point stencil sweep, N = 2^24, 8 ranks,
     ``shard="slice"`` (halo windows);
   - ``heat2d``: one five-point ``collapse(2)`` sweep, 4096 x 4096, a 4x2
     mesh, ``shard="slice"``;

4. **kernel vs plain** — the span kernel's dense values against
   ``span_values_plain`` on the same inputs, on every lane that holds an
   iteration, for the 8 block families and a body of every other op the
   template emits (``ops``) at a small size, and for every span of the
   three programs: rtol = tol and atol = tol x the largest |plain value|
   (tol = 1e-5 for pointwise bodies; 1e-4 where the body sums a trailing
   axis, whose summation order differs).  Each comparison also shows
   that the same check rejects the plain values scaled by 1.001 and all
   zeros;
5. **times** — per program, CUDA events, the median of 10 runs after
   warm-up, each run 20 calls back to back (time per call): the span
   kernel (its wrapper's launch, one per span), its plain version, one
   PyTorch call that
   computes the same values where there is one (``F.conv1d`` /
   ``F.conv2d``, cuDNN without TF32; a yardstick the port never calls),
   and the bound: the larger of the bytes the function must move over the
   card's 3.35 TB/s and its flops over the 67 TFLOP/s float32 rate
   (H100 SXM data sheet).  The bytes are each env array the body reads,
   once, and each output's values on the loop's iterations, once — not
   the halo windows or the padding slots of the chunk layout.

6. **K2 vs plain** — the flash-attention kernels (CUDA C++, built by
   ``nvcc`` for ``sm_90a`` into ``build/kernels/`` in a thread started
   with the script, while phases 2-5 run: ``wgmma`` fed by TMA for 16-bit
   types, register-tiled FMAs for float32) against their plain version on
   the card: the 7 cases of ``tests/test_kernels.py`` in their own types
   and again in bfloat16, a head_dim of 72 in bfloat16 and float32, a
   ragged head_dim of 256 (B=1, H=2, KV=1, S=300) in bfloat16 and
   float16, and gemma3-1b's two attention shapes (H=4, KV=1, hd=256,
   S=4096, causal, window 512 and none) at B=1 and B=2 in bfloat16 and
   float32.  Two checks at tol = 2e-5 (float32), 5e-3 (float16) and
   1e-2 (bfloat16: one output rounding is at most 2^-7 relative): the
   ``agree`` rule of phase 4, which rejects the plain output scaled by
   1.001 (float32) or by 1 + 10 x tol (16-bit types, whose rounding is
   coarser than 0.1%), and all zeros; and ``agree_rows``, which holds
   each query row to tol x (|value| + the row's RMS), so that an error
   in the small outputs of long causal rows (~0.03 at S=4096, where
   tol x max|value| is as large) shows; it also rejects those wrong
   outputs and one row moved by a tenth of its RMS;
7. **prefill** — gemma3-1b at full width, weights from a seeded
   ``torch.Generator`` on the card, two prompts of 4096 tokens:
   ``DecoderLM.prefill(impl="kernel")`` against ``impl="chunked"``
   (plain PyTorch) in the same type: logits and every layer's k/v cache
   under ``agree`` at tol = 1e-4 in float32 and 1e-1 in bfloat16 (where
   both paths lie ~4e-2 from float32 by bf16 rounding through 26
   layers), positions equal; in bfloat16 the kernel path's worst gap to
   the float32 result may not exceed 1.5 x the chunked path's; K2 launches exactly once per attention layer, by
   window (4 global, 22 local), and its kernel-table rows carry those
   counts; timed end to end in float32 and bfloat16 under both impls;
8. **serving** — ``ServeEngine(n_slots=4, cache_len=4096, float32)``
   answers 8 requests of 16-2048 prompt tokens and 16
   new tokens (K2: 26 launches per prefill).  Each request is replayed
   through a single-sequence reference (``prefill(impl="chunked")`` then
   ``decode_step``), teacher-forced on the engine's tokens: at every step
   the engine's token must score within 1e-3 x max|logit| of that step's
   best reference logit (random-weight logits over 262144 tokens hold
   near-ties, so argmax tokens are not compared);
9. **K2 times** — at both gemma3-1b shapes for one prompt (B=1), both
   types: the kernel, its plain version, ``F.scaled_dot_product_attention``
   (``enable_gqa``, ``is_causal`` or a boolean window mask; a yardstick the
   port never calls) and the bound: the larger of q, k, v and o's bytes
   over 3.35 TB/s and 4 x hd flops per allowed (query, key) pair and head
   over 989 TFLOP/s (bfloat16) or 67 TFLOP/s (float32); the kernel's and
   SDPA's times at B=2 (what the prefill launches) are printed beside,
   and so are the kernel's device time per launch under
   ``torch.profiler`` and the host's time to enqueue a call (when the
   host is the slower, back-to-back event timing reads the host);
10. **K3 vs plain** — the SSD-scan kernel (CUDA C++, built by ``nvcc``
    into ``build/kernels/`` in a thread started with the script) against
    its plain version (the per-token recurrence) on the card: the 5
    cases of ``tests/test_kernels.py`` and mamba2-130m's shape (B=2,
    S=4096, H=24, P=64, N=128, chunk 256) in float32 and bfloat16, under
    ``agree`` at tol = 1e-4 (float32), 5e-3 (float16), 1e-2 (bfloat16),
    each check rejecting the plain output scaled by 1.001 (float32) or by
    1 + 10 x tol (16-bit), and all zeros; its launch counter moves once
    per call;
11. **SSM prefill** — mamba2-130m at full width and depth (24 layers,
    d_model 768), weights from a seeded ``torch.Generator`` on the card,
    two prompts of 4096 tokens in float32 and bfloat16: (a) every
    layer's ``ssd_chunked`` arguments are recorded during one prefill,
    and ``ops.ssd_scan`` (K3 plus ``D*x``) on them equals that layer's
    ``ssd_chunked`` output (``agree`` at tol 1e-4 in float32, 1e-2 in
    bfloat16, h0 zero), its counter set to 0 before and read after (one
    launch per layer); (b) one 512-token prompt (two chunks): the
    prefill's logits and every layer's ``h`` / ``conv`` equal those of
    512 ``decode_step``s from an empty cache (float32, ``agree`` at tol
    1e-4); prefill timed end to end in both types;
12. **SSM serving** — phase 8's engine, requests and teacher-forced
    check on mamba2-130m;
13. **K3 times** — at mamba2-130m's shape in float32 and bfloat16: the
    kernel, its plain version and the bound: the larger of x, dt, A, B,
    C and y's bytes over 3.35 TB/s and the chunked algorithm's flops
    over 67 TFLOP/s (float32) or 989 TFLOP/s (bfloat16): C.B^T once per
    (b, chunk) on its causal pairs, scores.x on them per head, C.h_prev
    and the state update per head on every chunk that has a state to
    read or a successor to feed.  No single PyTorch call computes the
    scan, so its library time is null.

The last two lines are the kernel table as one JSON object and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import json
import math
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
FP32_FLOPS_PER_S = 67e12       # H100 SXM float32 rate outside tensor cores
N1 = 1 << 24                   # rank-1 programs (EXTRALARGE jacobi-1d: 2000000)
N2 = 4096                      # heat2d side (EXTRALARGE heat-3d: 200^3 cells)
REPS = 10                      # timed runs per number (the median is kept)
INNER = 20                     # back-to-back calls in one timed run
REPLACES = "src/repro/core/pallas_lower.py:343"
SOURCE = "src/repro_torch/kernels/span_kernel.py"
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core rate
K2_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
K2_REPLACES = "src/repro/kernels/flash_attention.py:98"
ARCH = "gemma3-1b"
PREFILL_LEN = 4096             # tokens in each of the two prompts
SERVE = dict(requests=8, shortest=16, longest=2048, max_new=16,
             n_slots=4, cache_len=4096)
PREFILL_TOL = 1e-4             # kernel vs chunked prefill, float32
PREFILL_TOL_BF16 = 1e-1        # kernel vs chunked prefill, bfloat16
BF16_GAP_RATIO = 1.5           # kernel's bf16 gap to f32 over chunked's
SERVE_TOL = 1e-3               # engine token vs best reference logit
K3_SOURCE = "src/repro_torch/csrc/ssd_scan.cu"
K3_REPLACES = "src/repro/kernels/ssd_scan.py:65"
SSM_ARCH = "mamba2-130m"
SSM_RECURRENCE_LEN = 512       # prompt held against token-by-token decode
K3_TOL = {"float32": 1e-4, "float16": 5e-3, "bfloat16": 1e-2}
SSM_PREFILL_TOL = 1e-4         # chunked prefill vs recurrence, float32


def model_config():
    from repro_torch.configs import get_config

    return get_config(ARCH)


def ssm_config():
    from repro_torch.configs import get_config

    return get_config(SSM_ARCH)


def _setup():
    """Import the port from this checkout; fail without a card."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: no port package under {src}")
    sys.path.insert(0, str(src))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps=REPS, inner=INNER, warmup=3) -> float:
    """Milliseconds per call of ``fn``: the median over ``reps`` runs,
    each run ``inner`` calls back to back between two CUDA events (so the
    card, not the host's launch latency, sets the time of a short kernel)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Programs
# ---------------------------------------------------------------------------


def pi_program(omp, torch, dev, n=N1):
    @omp.parallel_for(stop=n, name="pi_fill")
    def fill(i, env):
        x = (i + 0.5) / n
        return {"sum": omp.at(i, 4.0 / (1.0 + x * x))}

    @omp.parallel_for(stop=n, reduction={"total": "+"}, name="pi_sum")
    def total(i, env):
        return {"total": omp.red(env["sum"][i] / n)}

    env = {"sum": torch.zeros(n, device=dev),
           "total": torch.zeros((), device=dev)}
    return [(fill, "replicate"), (total, "replicate")], env, (8,), ("data",)


def jacobi1d_program(omp, torch, dev, n=N1):
    @omp.parallel_for(start=1, stop=n - 1, name="jacobi1d")
    def sweep(i, env):
        return {"b": omp.at(i, (env["a"][i - 1] + env["a"][i]
                                + env["a"][i + 1]) / 3.0)}

    g = torch.Generator(device=dev).manual_seed(1)
    env = {"a": torch.rand(n, generator=g, device=dev),
           "b": torch.zeros(n, device=dev)}
    return [(sweep, "slice")], env, (8,), ("data",)


def heat2d_program(omp, torch, dev, n=N2):
    @omp.parallel_for(start=(1, 1), stop=(n - 1, n - 1), collapse=2,
                      name="heat2d")
    def heat(i, j, env):
        v = 0.25 * (env["a"][i - 1, j] + env["a"][i + 1, j]
                    + env["a"][i, j - 1] + env["a"][i, j + 1])
        return {"b": omp.at((i, j), v)}

    g = torch.Generator(device=dev).manual_seed(2)
    env = {"a": torch.rand(n, n, generator=g, device=dev),
           "b": torch.zeros(n, n, device=dev)}
    return [(heat, "slice")], env, (4, 2), ("i", "j")


def library_call(name, torch, env):
    """One PyTorch call computing the span kernel's values, or None."""
    F = torch.nn.functional
    if name == "jacobi1d":
        x = env["a"].view(1, 1, -1)
        w = torch.full((1, 1, 3), 1.0 / 3.0, device=x.device)
        return lambda: F.conv1d(x, w)
    if name == "heat2d":
        a = env["a"].view(1, 1, *env["a"].shape)
        w = torch.tensor([[0.0, 0.25, 0.0], [0.25, 0.0, 0.25],
                          [0.0, 0.25, 0.0]], device=a.device).view(1, 1, 3, 3)
        return lambda: F.conv2d(a, w)
    return None


# ---------------------------------------------------------------------------
# The 8 block families at a small size (torch bodies)
# ---------------------------------------------------------------------------


def families(omp, torch, dev):
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.rand(*shape, generator=g, device=dev) + 0.5

    out = []

    @omp.parallel_for(start=1, stop=37, step=2, schedule=omp.dynamic(3),
                      name="map")
    def map_(i, env):
        return {"y": omp.at(i, env["x"][i] * 2.0 + 1.0)}
    out.append((map_, {"x": rnd(40), "y": -torch.ones(40, device=dev)}))

    @omp.parallel_for(start=2, stop=46, name="stencil")
    def stencil(i, env):
        return {"y": omp.at(i, (env["x"][i - 2] + env["x"][i]
                                + env["x"][i + 2]) / 3.0)}
    out.append((stencil, {"x": rnd(48), "y": -torch.ones(48, device=dev)}))

    @omp.parallel_for(stop=9, schedule=omp.guided(), name="strided")
    def strided(i, env):
        return {"z": omp.at(3 * i + 1, env["x"][i] + 3.0)}
    out.append((strided, {"x": rnd(9), "z": -torch.ones(26, device=dev)}))

    @omp.parallel_for(stop=19, reduction={"s": "max"}, name="reduce")
    def reduce_(i, env):
        return {"s": omp.red(env["x"][i])}
    out.append((reduce_, {"x": rnd(19), "s": torch.tensor(0.5, device=dev)}))

    @omp.parallel_for(stop=7, schedule=omp.static(2), name="put")
    def put(i, env):
        return {"w": omp.put(torch.full((3,), 1.0, device=i.device) * i)}
    out.append((put, {"x": rnd(7), "w": torch.zeros(3, device=dev)}))

    @omp.parallel_for(stop=15, reduction={"s": "+"}, name="combo")
    def combo(i, env):
        v = env["x"][i] * env["x"][i]
        return {"y": omp.at(i, v), "s": omp.red(v)}
    out.append((combo, {"x": rnd(15), "y": torch.zeros(15, device=dev),
                        "s": torch.tensor(1.0, device=dev)}))

    @omp.parallel_for(stop=(9, 7), collapse=2, reduction={"s": "*"},
                      name="rowreduce2")
    def rowreduce2(i, j, env):
        return {"s": omp.red(env["x"][i, j])}
    out.append((rowreduce2, {"x": 1.0 + 0.01 * rnd(9, 7)}))

    @omp.parallel_for(stop=(8, 6), collapse=2, name="matmul2")
    def matmul2(i, j, env):
        return {"C": omp.at((i, j), (env["A"][i] * env["B"][:, j]).sum())}
    out.append((matmul2, {"A": rnd(8, 5), "B": rnd(5, 6),
                          "C": -torch.ones(8, 6, device=dev)}))

    # every other op the template emits: exp/log/sqrt/abs/neg/reciprocal,
    # where/comparisons/maximum/minimum, a 0-d env scalar, amax/amin, and
    # integer index arithmetic with a negative dividend (Python's %)
    @omp.parallel_for(start=1, stop=29, reduction={"m": "max"}, name="ops")
    def ops(i, env):
        x = env["x"][i]
        y = torch.where(x > 0.0, torch.exp(x), torch.sqrt(torch.abs(x)))
        y = torch.maximum(y, env["s"]) - torch.log(1.0 + x * x)
        z = torch.minimum(-x, 1.0 / (2.0 + x * x))
        r = env["R"][i]
        return {"y": omp.at(i, y / (1.0 + i) + z),
                "m": omp.red(r.amax() - r.amin()
                             + env["x"][(i * 2 - 20) % 7 - 3])}
    out.append((ops, {"x": 2.0 * rnd(32) - 2.0, "R": rnd(32, 6),
                      "s": torch.tensor(0.25, device=dev),
                      "y": torch.zeros(32, device=dev)}))
    return out


def agree(torch, got, want, tol) -> bool:
    """``got`` within rtol = tol and atol = tol x max|want| of ``want``:
    the absolute term scales with the values compared, so values of order
    1e-7 are held as closely as values of order 1."""
    scale = want.abs().max().item() if want.numel() else 0.0
    return got.shape == want.shape and torch.allclose(
        got, want, rtol=tol, atol=tol * scale)


def hold(torch, got, want, tol, label) -> tuple[float, float]:
    """``got`` under ``agree`` against ``want`` (compared in float32);
    raises if not, or if the same check would pass a wrong output
    (``want`` x 1.001 in float32, x (1 + 10 tol) in 16 bits, or zeros).
    Returns the max abs error and max|want|."""
    bump = 1.001 if want.dtype == torch.float32 else 1 + 10 * tol
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    if not agree(torch, got, want, tol):
        raise AssertionError(
            f"{label}: max abs err {err:.3e} (rtol={tol}, atol={tol} x "
            f"{want.abs().max().item():.3e})")
    if agree(torch, want * bump, want, tol) or agree(
            torch, torch.zeros_like(want), want, tol):
        raise AssertionError(f"{label}: the check at tol={tol} cannot tell "
                             "a wrong output")
    return err, want.abs().max().item()


def agree_rows(torch, got, want, tol) -> bool:
    """``got`` within tol x (|want| + the RMS of want's row) of ``want``,
    a row being the last axis: each row is held at its own scale, so a
    fault in the small rows of a long causal band shows however large
    the largest row is, while rounding, relative, passes."""
    rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
    return got.shape == want.shape and bool(
        ((got - want).abs() <= tol * (want.abs() + rms)).all())


def hold_rows(torch, got, want, tol, label) -> float:
    """``got`` under ``agree_rows`` against ``want`` (compared in float32);
    raises if not, or if the same check would pass ``want`` x (1 + 10 tol),
    zeros, or ``want`` with its last row moved by a tenth of that row's
    RMS.  Returns the worst |got - want| / (|want| + row RMS)."""
    got, want = got.float(), want.float()
    rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
    worst = ((got - want).abs() / (want.abs() + rms)).nan_to_num(
        nan=0.0).max().item()
    if not agree_rows(torch, got, want, tol):
        raise AssertionError(f"{label}: worst |err| / (|want| + row RMS) "
                             f"{worst:.3e} > {tol}")
    moved = want.clone()
    moved[..., -1, :] += 0.1 * rms[..., -1, :]
    if any(agree_rows(torch, w, want, tol) for w in (
            want * (1 + 10 * tol), torch.zeros_like(want), moved)):
        raise AssertionError(f"{label}: the row check at tol={tol} cannot "
                             "tell a wrong output")
    return worst


def compare_spans(torch, omp, transform, kernel_lower, span_kernel, prog,
                  env, mesh, shard, label):
    """Kernel vs plain on every span of one compiled block, on the lanes
    that hold an iteration (the kernel writes no other); returns the max
    abs error."""
    comp = omp.compile(prog, mesh, lowering="kernel", shard=shard,
                       env_like=env)
    mask = kernel_lower.lane_mask(comp.plan, mesh.device)
    err = 0.0
    for span in comp.kernel_plan.spans:
        repl, slabs = transform.stage_inputs(comp.plan, env)
        got = span_kernel.span_values(comp.plan, prog, slabs, repl,
                                      span.source, mesh.device)
        want = span_kernel.span_values_plain(comp.plan, prog, slabs, repl,
                                             mesh.device)
        tol = 1e-4 if "tl.sum(" in span.source.text else 1e-5
        for k in want:
            g, w = got[k][mask], want[k][mask]
            e = (g - w).abs().max().item()
            if not agree(torch, g, w, tol):
                raise AssertionError(
                    f"{label} {k}: kernel != plain, max abs err {e:.3e} "
                    f"(rtol={tol}, atol={tol} x {w.abs().max().item():.3e})")
            if w.abs().max().item() > 0 and (
                    agree(torch, w * 1.001, w, tol)
                    or agree(torch, torch.zeros_like(w), w, tol)):
                raise AssertionError(f"{label} {k}: the check at tol={tol} "
                                     "cannot tell a wrong kernel")
            err = max(err, e)
    print(f"kernel-vs-plain {label}: {len(comp.kernel_plan.spans)} span(s) "
          f"max_abs_err={err:.3e}")
    return err


# ---------------------------------------------------------------------------
# K2: flash attention
# ---------------------------------------------------------------------------


def k2_cases(torch):
    """(label, b, h, kv, sq, sk, hd, causal, window, dtype, tol): the 7
    cases of tests/test_kernels.py in their own types (float32, the
    ragged case float16) and each again in bfloat16; a head_dim of 72 (a
    multiple of 8, not of 16) in bfloat16 and float32; a ragged head_dim
    of 256 (the 16-bit kernel's 3-stage ring) in bfloat16 and float16;
    gemma3-1b's two
    attention shapes (from its config) at B=1 and at B=2 (what its
    prefill of two prompts launches) in bfloat16 and float32."""
    f32, f16, bf16 = torch.float32, torch.float16, torch.bfloat16
    tols = {f32: 2e-5, f16: 5e-3, bf16: 1e-2}
    small = [
        ("mha", (1, 4, 4, 64, 64, 32, True, None), f32),
        ("gqa", (2, 8, 2, 128, 128, 64, True, None), f32),
        ("gqa+window", (1, 4, 1, 96, 96, 64, True, 32), f32),
        ("decode", (2, 4, 4, 1, 160, 64, True, None), f32),
        ("bidir", (1, 2, 2, 64, 64, 128, False, None), f32),
        ("ragged", (1, 4, 2, 200, 200, 64, True, None), f16),
        ("suffix+window", (1, 2, 1, 48, 80, 32, True, 16), f32),
    ]
    cases = []
    for label, shape, dtype in small:
        for dt in (dtype, bf16):
            cases.append((label, *shape, dt, tols[dt]))
    for dt in (bf16, f32):
        cases.append(("hd72", 1, 4, 2, 130, 150, 72, True, None, dt,
                      tols[dt]))
    for dt in (bf16, f16):
        cases.append(("hd256", 1, 2, 1, 300, 300, 256, True, None, dt,
                      tols[dt]))
    for b in (1, 2):
        for label, window in gemma_windows():
            for dt in (bf16, f32):
                cases.append((label, *gemma_shape(b), True, window, dt,
                              tols[dt]))
    return cases


def gemma_windows():
    cfg = model_config()
    return (("global", None), ("local", cfg.sliding_window))


def gemma_shape(b=1):
    """(b, h, kv, sq, sk, hd) of an attention layer over ``b`` prompts."""
    cfg = model_config()
    return (b, cfg.n_heads, cfg.n_kv_heads, PREFILL_LEN, PREFILL_LEN,
            cfg.head_dim)


def k2_inputs(torch, dev, b, h, kv, sq, sk, hd, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                 for shape in ((b, h, sq, hd), (b, kv, sk, hd),
                               (b, kv, sk, hd)))


def check_k2(torch, fa, q, k, v, causal, window, tol,
             label) -> tuple[float, float]:
    """K2 against its plain version on the same inputs, under ``hold`` and
    ``hold_rows`` at the same tol; returns the max abs error and the worst
    error relative to its row.  Also shows that each check rejects a
    wrong output."""
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    label = f"K2 {label}: kernel != plain"
    return (hold(torch, got, want, tol, label)[0],
            hold_rows(torch, got, want, tol, label))


def band_pairs(sq, sk, causal, window) -> int:
    """Allowed (query, key) pairs of one head: what the kernel must
    compute for these shapes."""
    total = 0
    for i in range(sq):
        qp = i + sk - sq
        hi = min(qp, sk - 1) if causal else sk - 1
        lo = max(0, qp - window + 1) if window is not None else 0
        total += max(0, hi - lo + 1)
    return total


def sdpa_call(torch, q, k, v, window):
    """One PyTorch call computing K2's function (a yardstick only)."""
    F = torch.nn.functional
    if window is None:
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
    i = torch.arange(q.shape[2], device=q.device)[:, None]
    j = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = (j <= i) & (j > i - window)
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


def k2_phase(torch, dev, card):
    """Phase 6: every K2 case against the plain version; returns the max
    abs error of each gemma3-1b shape and type."""
    from repro_torch.kernels import flash_attention as fa

    errs = {}
    for n, case in enumerate(k2_cases(torch)):
        label, b, h, kv, sq, sk, hd, causal, window, dtype, tol = case
        q, k, v = k2_inputs(torch, dev, b, h, kv, sq, sk, hd, dtype, n)
        err, row_err = check_k2(torch, fa, q, k, v, causal, window, tol,
                                f"{label} {dtype}")
        errs[(label, b, dtype)] = err
        print(f"K2-vs-plain {label}: B={b} H={h} KV={kv} Sq={sq} Sk={sk} "
              f"hd={hd} causal={causal} window={window} {dtype} "
              f"max_abs_err={err:.3e} worst_row_rel_err={row_err:.3e} "
              f"(tol {tol})")
    return errs


def k2_bound(torch, b, h, kv, sq, sk, hd, window, dtype):
    """(bound in s, what bounds it, flops, bytes, allowed pairs per
    head) of one K2 call at these shapes, causal."""
    pairs = band_pairs(sq, sk, True, window)
    flops = 4 * hd * h * b * pairs
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = size * (2 * b * h * sq * hd + 2 * b * kv * sk * hd)
    peak = (BF16_FLOPS_PER_S if dtype == torch.bfloat16
            else FP32_FLOPS_PER_S)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations", flops, nbytes,
            pairs)


def kernel_device_ms(torch, fn, name, calls=INNER) -> tuple[float, float]:
    """``calls`` calls of ``fn`` back to back under ``torch.profiler``: the
    device time per launch of the CUDA kernels whose names hold ``name``
    (what the card spent, whatever the host did; averaged over the
    launches the profiler recorded), and the host's
    milliseconds per call to enqueue them (``fn`` returning, before the
    card is waited for; timed apart from the profiler).  When the host's
    time is the larger, back-to-back event timing reads the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    mine = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and name in e.key]
    count = sum(e.count for e in mine)
    if not count:
        raise AssertionError(f"the profiler saw no launch of {name}")
    return sum(e.self_device_time_total for e in mine) / 1e3 / count, host_ms


def k2_times(torch, dev, card, errs, launches):
    """Phase 9: K2 rows of the kernel table at gemma3-1b's shapes for one
    prompt (B=1, the shape of the earlier kernels' times), with the
    kernel and SDPA at B=2 (what the prefill launches) printed beside
    them."""
    from repro_torch.kernels import flash_attention as fa

    rows = []
    for label, window in gemma_windows():
        for dtype in (torch.bfloat16, torch.float32):
            b, h, kv, sq, sk, hd = gemma_shape(1)
            q, k, v = k2_inputs(torch, dev, b, h, kv, sq, sk, hd, dtype, 7)
            ms = cuda_ms(torch, lambda: fa.flash_attention(
                q, k, v, causal=True, window=window))
            device_ms, host_ms = kernel_device_ms(
                torch, lambda: fa.flash_attention(
                    q, k, v, causal=True, window=window), "flash_fwd")
            plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, causal=True, window=window), reps=5, inner=5)
            lib = sdpa_call(torch, q, k, v, window)
            lib_err = (lib().float() - fa.flash_attention_plain(
                q, k, v, causal=True, window=window).float()).abs().max()
            library_ms = cuda_ms(torch, lib, reps=5, inner=5)
            bound_s, bound_by, flops, nbytes, pairs = k2_bound(
                torch, b, h, kv, sq, sk, hd, window, dtype)
            peak = flops / bound_s if bound_by == "operations" else None
            del q, k, v, lib
            q2, k2, v2 = k2_inputs(torch, dev, *gemma_shape(2), dtype, 8)
            ms2 = cuda_ms(torch, lambda: fa.flash_attention(
                q2, k2, v2, causal=True, window=window))
            library_ms2 = cuda_ms(torch, sdpa_call(
                torch, q2, k2, v2, window), reps=5, inner=5)
            bound2 = k2_bound(torch, *gemma_shape(2), window, dtype)[0]
            del q2, k2, v2
            tname = str(dtype).replace("torch.", "")
            rows.append({
                "name": f"flash_attention[{ARCH} {label} S={sq} {tname}]",
                "route": "cuda", "source": K2_SOURCE,
                "replaces": K2_REPLACES,
                "launches": launches[tname].get(window, 0),
                "max_abs_err": errs[(label, 1, dtype)], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
                "bound_by": bound_by, "library_ms": library_ms,
                "device_ms": device_ms, "host_ms": host_ms})
            rate = (f", {flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s = "
                    f"{bound_s / (ms * 1e-3):.1%} of peak"
                    if peak else "")
            print(f"times K2 {label} {tname} B=1: kernel {ms:.4f} ms"
                  f"{rate} (profiler: {device_ms:.4f} ms on the card a "
                  f"launch; the host enqueues a call in {host_ms:.4f} ms), "
                  f"plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} "
                  f"ms (max abs diff to plain {lib_err.item():.2e}), bound "
                  f"{bound_s * 1e3:.4f} ms ({bound_by}: {flops} flops, "
                  f"{nbytes} B at {HBM_BYTES_PER_S:.3g} B/s; {pairs} "
                  f"allowed pairs per head); B=2: kernel {ms2:.4f} ms, SDPA "
                  f"{library_ms2:.4f} ms, bound {bound2 * 1e3:.4f} ms on "
                  f"{card}")
    return rows


# ---------------------------------------------------------------------------
# K3: the SSD scan; mamba2-130m prefill and serving
# ---------------------------------------------------------------------------


def dtname(dtype) -> str:
    return str(dtype).replace("torch.", "")


def ssm_shape():
    """(b, s, h, p, n, chunk) of the SSD scan of one mamba2-130m prefill
    of two prompts."""
    cfg = ssm_config()
    return (2, PREFILL_LEN, cfg.ssm.n_heads(cfg.d_model), cfg.ssm.head_dim,
            cfg.ssm.d_state, cfg.ssm.chunk)


def k3_cases(torch):
    """(label, b, s, h, p, n, chunk, dtype): the 5 cases of
    tests/test_kernels.py, then mamba2-130m's shape (from its config) in
    float32 and bfloat16."""
    f32 = torch.float32
    cases = [
        ("small", 1, 64, 2, 16, 8, 16, f32),
        ("ragged-chunks", 2, 100, 4, 32, 16, 32, f32),
        ("n128", 1, 128, 3, 64, 128, 64, f32),
        ("f16", 2, 48, 2, 32, 16, 16, torch.float16),
        ("chunk>seq", 1, 33, 1, 8, 4, 64, f32),
    ]
    for dtype in (f32, torch.bfloat16):
        cases.append((SSM_ARCH, *ssm_shape(), dtype))
    return cases


def k3_inputs(torch, dev, b, s, h, p, n, dtype, seed):
    """x, dt, A, Bm, Cm drawn as tests/test_kernels.py draws them."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x = rnd(b, s, h, p).to(dtype)
    dt = rnd(b, s, h).abs() * 0.1
    A = -rnd(h).abs() - 0.1
    return x, dt, A, rnd(b, s, n).to(dtype), rnd(b, s, n).to(dtype)


def check_k3(torch, ssd, args, chunk, tol, label) -> tuple[float, float]:
    """K3 against its plain version on the same inputs, its counter moving
    once; returns the max abs error and max|plain|."""
    before = ssd.LAUNCHES
    got = ssd.ssd_scan_kernel(*args, chunk=chunk)
    torch.cuda.synchronize()
    if ssd.LAUNCHES != before + 1:
        raise AssertionError(f"K3 {label}: {ssd.LAUNCHES - before} "
                             "launches counted, want 1")
    want = ssd.ssd_scan_plain(*args)[0]
    return hold(torch, got, want, tol, f"K3 {label}: kernel != plain")


def k3_phase(torch, dev):
    """Phase 10: every K3 case against the plain version; returns the max
    abs error by (label, type)."""
    from repro_torch.kernels import ssd_scan as ssd

    errs = {}
    for i, (label, b, s, h, p, n, chunk, dtype) in enumerate(
            k3_cases(torch)):
        args = k3_inputs(torch, dev, b, s, h, p, n, dtype, i)
        tname = dtname(dtype)
        tol = K3_TOL[tname]
        err, scale = check_k3(torch, ssd, args, chunk, tol,
                              f"{label} {tname}")
        errs[label, tname] = err
        print(f"K3-vs-plain {label}: B={b} S={s} H={h} P={p} N={n} "
              f"chunk={chunk} {tname} max_abs_err={err:.3e} (tol {tol}, "
              f"max|plain| {scale:.3e})")
    return errs


def ssm_prefill_phase(torch, dev, card):
    """Phase 11; returns (model, params, K3 launches by (path, type):
    path "ops" is ops.ssd_scan on the layers' activations, "model" the
    model's own prefill)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import build_model
    from repro_torch.models import ssm as ssm_mod

    cfg = ssm_config()
    f32, bf16 = torch.float32, torch.bfloat16
    t0 = time.perf_counter()
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params, _ = model.init(gen)
    tokens = torch.randint(1, cfg.vocab_size, (2, PREFILL_LEN),
                           generator=gen, device=dev, dtype=torch.int32)
    n_params = sum(t.numel() for t in _leaves(params))
    torch.cuda.synchronize()
    print(f"prefill {cfg.name}: {n_params} parameters (float32, seed 0) "
          f"built on the card in {time.perf_counter() - t0:.2f} s; "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.ssm.n_heads(cfg.d_model)} SSM heads of "
          f"{cfg.ssm.head_dim}, d_state {cfg.ssm.d_state}, chunk "
          f"{cfg.ssm.chunk}; 2 prompts of {PREFILL_LEN} tokens")

    def run(dtype, toks=tokens):
        cache = model.init_cache(toks.shape[0], toks.shape[1], dtype=dtype,
                                 device=dev)
        return model.prefill(params, {"tokens": toks}, cache,
                             compute_dtype=dtype)

    # (a) K3's path, as in the reference: its entry point ops.ssd_scan on
    # every layer's own activations.  The prefill records what each layer
    # hands ssd_chunked (the model path, which launches no K3); then
    # ops.ssd_scan runs on all of it, counted, and each output is held
    # against that layer's ssd_chunked output.
    chunked = ssm_mod.ssd_chunked
    launches = {}
    for dtype in (f32, bf16):
        calls = []

        def record(*args, **kw):
            out = chunked(*args, **kw)
            calls.append((args, kw, out[0]))
            return out

        tname = dtname(dtype)
        ssm_mod.ssd_chunked = record
        ssd.LAUNCHES = 0
        try:
            logits, _ = run(dtype)
        finally:
            ssm_mod.ssd_chunked = chunked
        torch.cuda.synchronize()
        launches["model", tname] = ssd.LAUNCHES
        if ssd.LAUNCHES:
            raise AssertionError(f"prefill {tname}: the model path launched "
                                 f"K3 {ssd.LAUNCHES} times; it runs "
                                 "ssd_chunked, as the reference does")
        if logits.shape != (2, cfg.vocab_size) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"prefill {tname}: logits "
                                 f"{tuple(logits.shape)} not finite")
        if len(calls) != cfg.n_layers:
            raise AssertionError(f"prefill {tname}: ssd_chunked ran "
                                 f"{len(calls)} times, want one per layer")
        for layer, (_, kw, _) in enumerate(calls):
            h0 = kw.get("h0")
            if h0 is not None and bool(h0.any()):
                raise AssertionError(f"prefill {tname} layer {layer}: h0 "
                                     "is not zero in a fresh prefill")
        ssd.LAUNCHES = 0
        outs = [ops.ssd_scan(*args, chunk=kw["chunk"])
                for args, kw, _ in calls]
        torch.cuda.synchronize()
        launches["ops", tname] = ssd.LAUNCHES
        if ssd.LAUNCHES != cfg.n_layers:
            raise AssertionError(f"prefill {tname}: K3 launched "
                                 f"{ssd.LAUNCHES} times, want one per layer")
        tol = K3_TOL[tname]
        worst = (0.0, 0)
        for layer, (got, (_, _, want)) in enumerate(zip(outs, calls)):
            err, scale = hold(torch, got, want, tol, f"prefill {tname} "
                              f"layer {layer}: ops.ssd_scan != ssd_chunked")
            worst = max(worst, (err / (scale or 1.0), layer))
        print(f"prefill {cfg.name} {tname}: ops.ssd_scan (K3 + D*x) == "
              f"ssd_chunked on the activations of all {cfg.n_layers} layers "
              f"(rtol={tol}, atol={tol} x max|value|; worst err / scale "
              f"{worst[0]:.3e} in layer {worst[1]}); K3 launches: "
              f"{launches['ops', tname]} by ops.ssd_scan, "
              f"{launches['model', tname]} by the model's prefill")
        del calls, outs

    # (b) the chunked scan equals the recurrence: prefill vs token by token
    n = SSM_RECURRENCE_LEN
    toks = tokens[:1, :n]
    logits, cache = run(f32, toks)
    dcache = model.init_cache(1, n, dtype=f32, device=dev)
    for t in range(n):
        dlogits, dcache = model.decode_step(
            params, dcache, toks[:, t],
            torch.full((1,), t, dtype=torch.int32, device=dev),
            compute_dtype=f32)
    worst = hold_prefill(torch, (dlogits, dcache), (logits, cache),
                         SSM_PREFILL_TOL,
                         f"prefill {cfg.name}: {n} decode steps != prefill",
                         names=("h", "conv"))
    print(f"prefill {cfg.name}: a {n}-token prompt ("
          f"{-(-n // cfg.ssm.chunk)} chunks) prefilled == {n} decode_steps "
          f"from an empty cache, float32 (logits and every layer's h and "
          f"conv: rtol={SSM_PREFILL_TOL}, atol={SSM_PREFILL_TOL} x "
          f"max|value|; worst err / scale {worst[0]:.3e} in {worst[1]})")

    wall = {}
    for dtype in (bf16, f32):
        ms = wall[dtype] = cuda_ms(torch, lambda: run(dtype), reps=3,
                                   inner=1, warmup=1)
        print(f"end-to-end prefill {cfg.name} {dtname(dtype)}: {ms:.2f} ms for "
              f"2 x {PREFILL_LEN} tokens, {2 * PREFILL_LEN / ms * 1e3:.0f} "
              f"tokens/s on {card}")
    profile_prefill(torch, lambda: run(bf16), card, wall[bf16],
                    f"{cfg.name} bfloat16")
    return model, params, launches


def k3_flops(b, s, h, p, n, chunk) -> int:
    """The products of the chunked scan on these shapes: C.B^T once per
    (b, chunk) on its causal pairs, scores.x on them per head, C.h_prev
    per head on every chunk but the first (whose h_prev is zero), the
    state update per head on every chunk but the last (which feeds no
    chunk), and the state recurrence between chunks.  The masks and
    exponentials (~3 operations per pair and head) are left out."""
    q = min(chunk, s)
    lens = [min(q, s - c * q) for c in range(-(-s // q))]
    pairs = sum(ln * (ln + 1) // 2 for ln in lens)
    flops = 2 * b * pairs * n
    flops += 2 * b * h * pairs * p
    flops += 2 * b * h * (sum(lens[1:]) + sum(lens[:-1])) * n * p
    flops += 2 * b * h * (len(lens) - 1) * n * p
    return flops


def k3_least_flops(b, s, h, p, n) -> tuple[int, int]:
    """The least products that compute the scan on these shapes, and the
    chunk that needs them.  The output does not depend on the chunk, so
    this is :func:`k3_flops` at its best chunk (~16 at mamba2-130m's
    shape: the intra-chunk pairs grow with it, the state work falls);
    the per-token recurrence (~5 S N P per (b, h)) needs more."""
    return min((k3_flops(b, s, h, p, n, q), q) for q in range(1, s + 1))


def k3_times(torch, dev, card, errs, launches):
    """Phase 13: K3 rows of the kernel table at mamba2-130m's shape."""
    from repro_torch.kernels import ssd_scan as ssd

    rows = []
    b, s, h, p, n, chunk = ssm_shape()
    for dtype in (torch.float32, torch.bfloat16):
        tname = dtname(dtype)
        args = k3_inputs(torch, dev, b, s, h, p, n, dtype, 7)
        before = ssd.LAUNCHES
        ssd.ssd_scan_kernel(*args, chunk=chunk)
        per_call = ssd.LAUNCHES - before
        ms = cuda_ms(torch, lambda: ssd.ssd_scan_kernel(*args, chunk=chunk))
        plain_ms = cuda_ms(torch, lambda: ssd.ssd_scan_plain(*args), reps=3,
                           inner=1, warmup=1)
        flops, best_chunk = k3_least_flops(b, s, h, p, n)
        # x, dt, A, Bm, Cm read once; y written once
        nbytes = sum(t.numel() * t.element_size() for t in args)
        nbytes += args[0].numel() * args[0].element_size()
        peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else \
            FP32_FLOPS_PER_S
        bound_s = max(nbytes / HBM_BYTES_PER_S, flops / peak)
        bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / peak
                    else "operations")
        rows.append({
            "name": f"ssd_scan[{SSM_ARCH} S={s} {tname}]", "route": "cuda",
            "source": K3_SOURCE, "replaces": K3_REPLACES,
            "launches": launches["ops", tname],
            "model_path_launches": launches["model", tname]
            + launches["serve"],
            "max_abs_err": errs[SSM_ARCH, tname], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
            "bound_by": bound_by, "library_ms": None})
        print(f"times K3 {tname}: kernel {ms:.4f} ms ({per_call} launch "
              f"per call: 4 CUDA grids; chunk {chunk}), plain "
              f"{plain_ms:.4f} ms, library none (no single PyTorch call "
              f"computes the scan), bound {bound_s * 1e3:.4f} ms ("
              f"{bound_by}: {flops} flops, the chunked scan's at its best "
              f"chunk {best_chunk} ({k3_flops(b, s, h, p, n, chunk)} at "
              f"chunk {chunk}), at {peak:.3g} flop/s; {nbytes} B at "
              f"{HBM_BYTES_PER_S:.3g} B/s; B={b} S={s} H={h} P={p} N={n}) "
              f"on {card}")
    return rows


def print_build(name, module, thread):
    """Raise what a kernel's build thread raised, else say what nvcc
    reported."""
    thread.join()
    if thread.error is not None:
        raise thread.error
    regs = sorted({line.split("Used ")[1].split(",")[0] for line in
                   module.BUILD_LOG.splitlines() if "Used " in line})
    print(f"build {name}: {module.SOURCE.name} -> build/kernels/ in "
          f"{thread.seconds:.2f} s (nvcc {' '.join(module.NVCC_FLAGS)}; "
          f"ptxas: {', '.join(regs) or 'cached build'})")


# ---------------------------------------------------------------------------
# gemma3-1b: prefill and serving
# ---------------------------------------------------------------------------


def prefill_phase(torch, dev, card):
    """Phase 7; returns (model, params, K2 launches of one prefill by type
    and window)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model

    cfg = model_config()
    f32, bf16 = torch.float32, torch.bfloat16
    t0 = time.perf_counter()
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params, _ = model.init(gen)
    tokens = torch.randint(1, cfg.vocab_size, (2, PREFILL_LEN),
                           generator=gen, device=dev, dtype=torch.int32)
    n_params = sum(t.numel() for t in _leaves(params))
    torch.cuda.synchronize()
    print(f"prefill {cfg.name}: {n_params} parameters (float32, seed 0) "
          f"built on the card in {time.perf_counter() - t0:.2f} s; "
          f"{cfg.n_layers} layers, 2 prompts of {PREFILL_LEN} tokens")

    def run(impl, dtype):
        cache = model.init_cache(2, PREFILL_LEN, dtype=dtype, device=dev)
        return model.prefill(params, {"tokens": tokens}, cache, impl=impl,
                             compute_dtype=dtype)

    # one K2 launch per attention layer, under that layer's window
    want_launches = collections.Counter(
        cfg.sliding_window if cfg.attn_kind(i) == "local" else None
        for i in range(cfg.n_layers))
    launches = {}
    ref = run("chunked", f32)
    for dtype, tol in ((f32, PREFILL_TOL), (bf16, PREFILL_TOL_BF16)):
        fa.LAUNCHES.clear()
        got = run("kernel", dtype)
        torch.cuda.synchronize()
        tname = str(dtype).replace("torch.", "")
        launches[tname] = dict(fa.LAUNCHES)
        if fa.LAUNCHES != want_launches:
            raise AssertionError(
                f"prefill {dtype}: K2 launched {dict(fa.LAUNCHES)} times "
                f"by window, want one per attention layer "
                f"{dict(want_launches)}")
        if got[0].shape != (2, cfg.vocab_size) or not bool(
                torch.isfinite(got[0]).all()):
            raise AssertionError(f"prefill {dtype}: logits "
                                 f"{tuple(got[0].shape)} not finite")
        want = ref if dtype == f32 else run("chunked", dtype)
        worst, where = hold_prefill(
            torch, got, want, tol,
            f"prefill {tname}: impl=kernel != impl=chunked")
        print(f"prefill {cfg.name}: impl=kernel == impl=chunked in {tname} "
              f"(logits and the k/v caches of all {cfg.n_layers} layers: "
              f"rtol={tol}, atol={tol} x max|value|; worst err / scale "
              f"{worst:.3e} in {where}; pos equal); K2 launches by window "
              f"{launches[tname]}")
        if dtype != f32:
            # how far each path's own rounding carries it from float32:
            # the kernel's may not exceed the plain path's by much
            gaps = {}
            for impl, out in (("kernel", got), ("chunked", want)):
                gaps[impl], where = worst_gap(prefill_pairs(out, ref))
                print(f"prefill {cfg.name}: impl={impl} {tname} against "
                      f"impl=chunked float32: worst err / scale "
                      f"{gaps[impl]:.3e} in {where}")
            if gaps["kernel"] > BF16_GAP_RATIO * gaps["chunked"]:
                raise AssertionError(
                    f"prefill {tname}: impl=kernel lies {gaps['kernel']:.3e}"
                    f" from float32, over {BF16_GAP_RATIO} x impl=chunked's "
                    f"{gaps['chunked']:.3e}")
        del got, want
    del ref
    prefill_ms = {}
    for impl in ("kernel", "chunked"):
        for dtype in (bf16, f32):
            ms = prefill_ms[impl, dtype] = cuda_ms(
                torch, lambda: run(impl, dtype), reps=3, inner=1, warmup=1)
            print(f"end-to-end prefill {cfg.name} impl={impl} {dtype}: "
                  f"{ms:.2f} ms for 2 x {PREFILL_LEN} tokens, "
                  f"{2 * PREFILL_LEN / ms * 1e3:.0f} tokens/s on {card}")
    profile_prefill(torch, lambda: run("kernel", bf16), card,
                    prefill_ms["kernel", bf16],
                    f"{cfg.name} bfloat16 impl=kernel", ("K2", "flash_fwd"))
    return model, params, launches


def profile_prefill(torch, fn, card, wall_ms, label, kernel=None):
    """One prefill (``fn()``) under ``torch.profiler``: its kernels' busy
    time against ``wall_ms`` (the same prefill timed without the
    profiler, whose own overhead stretches the wall time it sees), the
    share of the port's kernel ``kernel`` = (name, substring of its CUDA
    kernels' names) where given, and the kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy_ms:
        print(f"profile prefill {label}: the profiler recorded no device "
              "time")
        return
    share = ""
    if kernel is not None:
        mine = [e for e in kernels if kernel[1] in e.key]
        ms = sum(e.self_device_time_total for e in mine) / 1e3
        share = (f"; {kernel[0]} {ms:.1f} ms ({ms / busy_ms:.1%} of kernel "
                 f"time, {sum(e.count for e in mine)} launches)")
    print(f"profile prefill {label}: kernels busy {busy_ms:.1f} ms, "
          f"{busy_ms / wall_ms:.1%} of the unprofiled {wall_ms:.1f} ms "
          f"({prof_ms:.1f} ms wall under the profiler){share} on {card}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<5d} "
              f"{e.key[:100]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def prefill_pairs(got, want, names=("k", "v")):
    """(name, got, want) over two prefills' logits and every layer's cache
    entries ``names``, as float32; ``slot*`` caches are split by period,
    so ``cache slot1[p]`` is layer ``p x period + 1``."""
    (got_logits, got_cache), (want_logits, want_cache) = got, want
    pairs = [("logits", got_logits, want_logits)]
    for key in want_cache:
        for name in names:
            g, w = got_cache[key][name], want_cache[key][name]
            if key.startswith("slot"):
                pairs += [(f"cache {key}[{i}]/{name}", g[i], w[i])
                          for i in range(w.shape[0])]
            else:
                pairs.append((f"cache {key}/{name}", g, w))
    return [(n, g.float(), w.float()) for n, g, w in pairs]


def worst_gap(pairs):
    """The largest max abs err / max |want| of ``pairs``, and its name."""
    return max(((g - w).abs().max().item() / (w.abs().max().item() or 1.0),
                name) for name, g, w in pairs)


def hold_prefill(torch, got, want, tol, label, names=("k", "v")):
    """A prefill's (logits, cache) under ``agree`` against another's, the
    cache's positions equal where it keeps them; returns
    :func:`worst_gap` of the logits and every layer's cache entries
    ``names``.  Every reading is taken before a failure raises, so a
    failure names them all."""
    for key in want[1]:
        if "pos" in want[1][key] and not torch.equal(got[1][key]["pos"],
                                                     want[1][key]["pos"]):
            raise AssertionError(f"{label}: cache {key}/pos differ")
    pairs = prefill_pairs(got, want, names)
    worst = worst_gap(pairs)
    bad = [name for name, g, w in pairs if not agree(torch, g, w, tol)]
    if bad:
        raise AssertionError(
            f"{label} at rtol={tol}, atol={tol} x max|value| in "
            f"{', '.join(bad)}; worst err / scale {worst[0]:.3e} in "
            f"{worst[1]}")
    return worst


def serving_phase(torch, dev, card, model, params):
    """Phases 8 and 12: the engine on 8 requests, held against a
    teacher-forced single-sequence reference; returns the K3 launches of
    the engine's run."""
    import numpy as np

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.serving import Request, ServeEngine

    cfg = model.cfg
    f32 = torch.float32
    rng = np.random.default_rng(0)
    lens = rng.integers(SERVE["shortest"], SERVE["longest"] + 1,
                        size=SERVE["requests"])
    lens[:2] = SERVE["shortest"], SERVE["longest"]
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size,
                                               size=n).tolist(),
                    max_new_tokens=SERVE["max_new"])
            for i, n in enumerate(lens)]
    engine = ServeEngine(model, params, n_slots=SERVE["n_slots"],
                         cache_len=SERVE["cache_len"], compute_dtype=f32)
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    fa.LAUNCHES.clear()
    ssd.LAUNCHES = 0
    t0 = time.perf_counter()
    ticks = 0
    while engine.queue or any(r is not None for r in engine.slot_req):
        engine.tick()
        ticks += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, k3_launches = sum(fa.LAUNCHES.values()), ssd.LAUNCHES
    if k3_launches:
        raise AssertionError(f"serving: K3 launched {k3_launches} times; "
                             "the model path runs ssd_chunked")
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    if launches != n_attn * len(reqs):
        raise AssertionError(f"serving: K2 launched {launches} times, want "
                             f"{n_attn} per prefill x {len(reqs)}")
    for r in reqs:
        if not r.done or len(r.output) != SERVE["max_new"]:
            raise AssertionError(f"request {r.rid}: done={r.done}, "
                                 f"{len(r.output)} tokens")
    tokens = torch.as_tensor(engine.slot_last, dtype=torch.int32,
                             device=dev)
    pos = torch.as_tensor(engine.slot_pos, dtype=torch.int32, device=dev)
    tick_ms = cuda_ms(torch, lambda: model.decode_step(
        params, engine.caches, tokens, pos, compute_dtype=f32), reps=5,
        inner=3, warmup=1)
    n_new = sum(len(r.output) for r in reqs)
    print(f"serving {cfg.name}: {len(reqs)} requests (prompts "
          f"{sorted(int(n) for n in lens)} tokens, {SERVE['max_new']} new "
          f"each) on {SERVE['n_slots']} slots, cache_len "
          f"{SERVE['cache_len']}, float32, prefill impl=kernel: {ticks} "
          f"ticks, {wall * 1e3:.1f} ms wall, {n_new / wall:.1f} generated "
          f"tokens/s; decode tick (4 slots) {tick_ms:.3f} ms; K2 launches "
          f"{launches}, K3 launches {k3_launches} on {card}")

    worst, exact = 0.0, 0
    for r in reqs:
        prompt = torch.as_tensor(r.prompt, dtype=torch.int32,
                                 device=dev)[None]
        cache = model.init_cache(1, SERVE["cache_len"], dtype=f32,
                                 device=dev)
        logits, cache = model.prefill(params, {"tokens": prompt}, cache,
                                      impl="chunked", compute_dtype=f32)
        for t, tok in enumerate(r.output):
            if t:
                logits, cache = model.decode_step(
                    params, cache, torch.tensor([r.output[t - 1]],
                                                device=dev),
                    torch.tensor([len(r.prompt) + t - 1], device=dev),
                    compute_dtype=f32)
            row = logits[0]
            gap = (row.max() - row[tok]).item() / row.abs().max().item()
            if gap > SERVE_TOL:
                raise AssertionError(
                    f"request {r.rid} step {t}: engine token {tok} scores "
                    f"{gap:.2e} x max|logit| below the reference's best "
                    f"(token {int(row.argmax())}); tolerance {SERVE_TOL}")
            worst = max(worst, gap)
            exact += int(row.argmax()) == tok
    print(f"serving {cfg.name}: every engine token within {SERVE_TOL} x "
          f"max|logit| of the teacher-forced reference's best (worst "
          f"{worst:.2e}); {exact} of {n_new} equal its argmax")
    return k3_launches


def main(device: str = "cuda") -> int:
    sys.stdout.reconfigure(line_buffering=True)
    torch = _setup()
    import triton

    from repro_torch import omp
    from repro_torch.core import kernel_lower, transform
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import span_kernel
    from repro_torch.kernels import ssd_scan as ssd

    # nvcc runs while K1 builds and runs
    k2_build = BuildThread(fa.build)
    k3_build = BuildThread(ssd.build)
    dev = torch.device(device)
    card = card_line()
    print(f"card: {card}")
    print(f"versions: torch {torch.__version__} (CUDA {torch.version.cuda}) "
          f"triton {triton.__version__} python {sys.version.split()[0]}")

    programs = {"pi": pi_program(omp, torch, dev),
                "jacobi1d": jacobi1d_program(omp, torch, dev),
                "heat2d": heat2d_program(omp, torch, dev)}
    meshes = {name: omp.make_mesh(shape, axes, device=dev)
              for name, (_, _, shape, axes) in programs.items()}

    # -- build: generate + JIT-compile every span kernel of the programs ---
    built = {}
    for name, (blocks, env, _, _) in programs.items():
        t0 = time.perf_counter()
        comps = [omp.compile(p, meshes[name], lowering="kernel", shard=s,
                             env_like=env) for p, s in blocks]
        run_blocks(comps, env)          # first launch builds each kernel
        torch.cuda.synchronize()
        built[name] = comps
        paths = ", ".join(f"build/span_kernels/{sp.source.fn_name}.py"
                          for c in comps for sp in c.kernel_plan.spans)
        print(f"build {name}: {sum(c.kernel_plan.n_kernels for c in comps)} "
              f"span kernel(s) generated and built in "
              f"{time.perf_counter() - t0:.2f} s ({paths})")

    # -- programs: the main path, both lowerings, against the reference ----
    launches = {}
    for name, (blocks, env, _, _) in programs.items():
        ref = run_blocks([p for p, _ in blocks], env)
        coll = run_blocks([omp.compile(p, meshes[name], lowering="collective",
                                       shard=s) for p, s in blocks], env)
        span_kernel.LAUNCHES = 0
        kern = run_blocks(built[name], env)
        torch.cuda.synchronize()
        launches[name] = span_kernel.LAUNCHES
        planned = sum(c.kernel_plan.n_kernels for c in built[name])
        if launches[name] != planned or planned == 0:
            raise AssertionError(
                f"{name}: span kernel launched {launches[name]} times, "
                f"planned {planned}")
        for label, got in (("collective", coll), ("kernel", kern)):
            for k in ref:
                torch.testing.assert_close(
                    got[k], ref[k], rtol=1e-4, atol=1e-4,
                    msg=lambda m: f"{name}/{label} {k}: {m}")
                if not torch.isfinite(got[k]).all():
                    raise AssertionError(f"{name}/{label} {k}: not finite")
        shapes = {k: tuple(v.shape) for k, v in kern.items()}
        print(f"program {name}: collective and kernel == run_reference "
              f"(rtol=atol=1e-4); span launches={launches[name]} "
              f"(planned {planned}); outputs {shapes}")

    # -- kernel vs plain ----------------------------------------------------
    fam_mesh = {1: omp.make_mesh((4,), ("data",), device=dev),
                2: omp.make_mesh((2, 2), ("i", "j"), device=dev)}
    for prog, env in families(omp, torch, dev):
        compare_spans(torch, omp, transform, kernel_lower, span_kernel,
                      prog, env, fam_mesh[prog.rank], "slice",
                      f"family {prog.name}")
        fam = omp.compile(prog, fam_mesh[prog.rank], lowering="kernel",
                          shard="slice")(env)
        ref = prog(env)
        for k in ref:
            torch.testing.assert_close(fam[k], ref[k], rtol=1e-4, atol=1e-4)
    errs = {}
    for name, (blocks, env, _, _) in programs.items():
        errs[name] = 0.0
        for (prog, shard), comp in zip(blocks, built[name]):
            errs[name] = max(errs[name], compare_spans(
                torch, omp, transform, kernel_lower, span_kernel, prog, env,
                meshes[name], shard, f"program {name}/{prog.name}"))
            env = comp(env)

    # -- times ----------------------------------------------------------------
    rows = []
    for name, (blocks, env, _, _) in programs.items():
        ms = plain_ms = bound_s = 0.0
        bytes_moved = flops = 0
        lib_env = env
        for (prog, _), comp in zip(blocks, built[name]):
            repl, slabs = transform.stage_inputs(comp.plan, env)
            for span in comp.kernel_plan.spans:
                src = span.source
                ms += cuda_ms(torch, lambda: span_kernel.span_values(
                    comp.plan, prog, slabs, repl, src, dev))
                plain_ms += cuda_ms(torch, lambda: span_kernel.
                                    span_values_plain(comp.plan, prog, slabs,
                                                      repl, dev))
                # each env array the body reads, once; each output's
                # values on the loop's iterations, once
                trip = comp.plan.nest.total_trip
                b = sum(env[key].numel() * env[key].element_size()
                        for _, key in src.inputs)
                b += sum(trip * math.prod(shape[3 * prog.rank:])
                         * torch.empty((), dtype=dt).element_size()
                         for _, shape, dt in src.outputs)
                f = src.flops_per_lane * trip
                bytes_moved += b
                flops += f
                bound_s += max(b / HBM_BYTES_PER_S, f / FP32_FLOPS_PER_S)
            env = comp(env)
        lib = library_call(name, torch, lib_env)
        library_ms = cuda_ms(torch, lib) if lib is not None else None
        bound_by = ("bytes" if bytes_moved / HBM_BYTES_PER_S
                    >= flops / FP32_FLOPS_PER_S else "operations")
        rows.append({
            "name": f"span_kernel[{name}]", "route": "triton",
            "source": SOURCE, "replaces": REPLACES,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
            "bound_by": bound_by, "library_ms": library_ms})
        lib_s = "n/a" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"times {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {lib_s}, bound {bound_s * 1e3:.4f} ms ({bound_by}: "
              f"{bytes_moved} B at {HBM_BYTES_PER_S:.3g} B/s, {flops} flops "
              f"at {FP32_FLOPS_PER_S:.3g} flop/s) on {card}")
        # the whole block run a user calls: staging + compute + merges +
        # combines + reassembly, per lowering
        blocks_of = {"kernel": built[name], "collective": [
            omp.compile(p, meshes[name], lowering="collective", shard=s)
            for p, s in blocks]}
        run_ms = {low: cuda_ms(torch, lambda: run_blocks(bs, lib_env),
                               inner=5) for low, bs in blocks_of.items()}
        print(f"end-to-end {name}: Compiled.run kernel "
              f"{run_ms['kernel']:.4f} ms, collective "
              f"{run_ms['collective']:.4f} ms on {card}")

    # -- K2, gemma3-1b prefill and serving -----------------------------------
    print_build("K2", fa, k2_build)
    errs = k2_phase(torch, dev, card)
    model, params, k2_launches = prefill_phase(torch, dev, card)
    serving_phase(torch, dev, card, model, params)
    del model, params
    torch.cuda.empty_cache()
    rows += k2_times(torch, dev, card, errs, k2_launches)

    # -- K3, mamba2-130m prefill and serving ---------------------------------
    print_build("K3", ssd, k3_build)
    errs = k3_phase(torch, dev)
    model, params, k3_launches = ssm_prefill_phase(torch, dev, card)
    k3_launches["serve"] = serving_phase(torch, dev, card, model, params)
    del model, params
    torch.cuda.empty_cache()
    rows += k3_times(torch, dev, card, errs, k3_launches)

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


class BuildThread(threading.Thread):
    """Runs a kernel build beside the main thread; :attr:`error` holds
    what it raised, for the main thread to raise after ``join``."""

    def __init__(self, build):
        super().__init__(daemon=True)
        self._build, self.error, self.seconds = build, None, 0.0
        self.start()

    def run(self):
        t0 = time.perf_counter()
        try:
            self._build()
        except BaseException as e:          # re-raised by the main thread
            self.error = e
        self.seconds = time.perf_counter() - t0


def run_blocks(blocks, env):
    """Run blocks in order (compiled programs or ParallelFor references),
    each seeing the previous one's outputs."""
    for b in blocks:
        env = b(env)
    return env


if __name__ == "__main__":
    raise SystemExit(main())
