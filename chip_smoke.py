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
   iteration, for the 8 block families, a body of every other op the
   template emits (``ops``) and matmul2's product as ``torch.dot``
   (``dot2``: the rank-2 outer tile on ``tl.dot``) at a small size, and
   for every span of the three programs: rtol = tol and atol = tol x the
   largest |plain value| (tol = 1e-5 for pointwise bodies; 1e-4 where
   the body sums a value axis or multiplies matrices, whose summation
   order differs).  Each comparison also shows
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
   head_dim of 100 (not a multiple of 8: the wrapper zero-pads q, k, v to
   104 and cuts the output back) in bfloat16 and float32, a
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
    1 + 10 x tol (16-bit), and all zeros, and under ``agree_rows`` with
    rows of P (each row of the output held at tol x (|value| + the row's
    RMS), so that a fault in small rows shows however large the largest
    output is); its launch counter moves once per call;
11. **SSM prefill** — mamba2-130m at full width and depth (24 layers,
    d_model 768), weights from a seeded ``torch.Generator`` on the card,
    two prompts of 4096 tokens in float32 and bfloat16: (a) every
    layer's ``ssd_chunked`` arguments are recorded during one prefill,
    and ``ops.ssd_scan`` (K3 plus ``D*x``) on them equals that layer's
    ``ssd_chunked`` output (``agree`` and ``agree_rows`` at tol 1e-4 in
    float32, 1e-2 in bfloat16, h0 zero), its counter set to 0 before and
    read after (one launch per layer); (b) one 512-token prompt (two chunks): the
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
    scan, so its library time is null;
14. **regions** — whole programs (``omp.region``) through
    ``omp.compile`` / ``Compiled.run``, float32, at PolyBench/C
    EXTRALARGE scale or above, the repo's own region benchmarks with
    torch bodies: ``jacobi_chain`` (two pointwise sweeps and a ``+``
    reduction, N = 2^24, 8 ranks: ONE span of 3 stages), ``heat3``
    (three ping-pong 3-point sweeps with halo exchanges, N = 2^24, 8
    ranks, ``static(2^16)``), ``multifield`` (3 fields x 5 sweeps, the
    same), ``heat2d_region`` (three 5-point sweeps, 4096 x 4096, a 4x2
    mesh, ``static(256)``) and ``pipeline`` (``examples/
    region_pipeline.py``, N = 2^24, with serial glue).  Each runs under
    ``fused`` (comm auto with the aggregate and the inline schedule;
    comm gather), ``collective`` (per-loop staging) and ``kernel``, and
    is held against its shared-memory run on the card, ``prog(env)``
    (rtol=atol=1e-4); aggregate equals inline bit for bit and moves the
    same ppermute bytes (``multifield``: at least 2x fewer ppermute
    launches aggregated); K1's counter moves by exactly the planned
    number of spans per kernel run, and by none under the other
    lowerings; the mesh's counters are printed per lowering;
15. **region spans vs plain** — every span of a kernel run on seeded
    normal data of the program's shapes (its stage feeds recorded as the
    executor hands them over; as many spans recorded as planned) launched
    again and held against ``span_values_plain_stages`` (the stages'
    plain values in order, forwarded keys handed over as tensors), stage
    by stage, under phase 4's ``agree`` rule and its rejections, and
    shown to reject the plain values moved by one lane (a forward served
    from the neighbouring lane's tile: ``tools/k1_planted_fault.py``
    plants one in the kernel);
16. **region times** — per span the kernel, its plain version and the
    bound (each env array the span reads from outside, once; each
    stage's outputs on the loop's iterations, once; forwarded
    intermediates count as outputs, never as reads); library null (no
    single PyTorch call computes a chain of loop bodies); and
    ``Compiled.run`` per lowering;
17. **polybench** — the 10 linear-algebra kernels of
    ``repro_torch.polybench`` (``gemm``, ``2mm``, ``3mm``, ``atax``,
    ``bicg``, ``mvt``, ``gesummv``, ``syrk``, ``syr2k``, ``covariance``)
    and the stencil ``jacobi2d`` (N = 2800, one sweep, its rows' columns
    wrapped by ``torch.roll``) at PolyBench/C 4.2.1 EXTRALARGE size,
    float32, 8 ranks, ``static`` schedule, with
    ``torch.backends.cuda.matmul.allow_tf32`` False (asserted and
    printed): ``Compiled.run`` under ``collective`` and ``kernel``
    against ``run_reference`` (rtol=atol=1e-4); K1 launches once per
    block (counted around the kernel run); every block's kernel holds one
    ``tl.dot`` per ``mm``, each stating its float32 precision (3xTF32 or
    IEEE, never a bare TF32), and one row-sum K loop per ``mv`` (no
    ``tl.dot``); each span against ``span_values_plain`` under ``agree``
    (phase 4's tol; 1e-5 on a matrix product's span, ``PB_MM_TOL``) and
    ``agree_rows`` (one row per lane, phase 4's tol), both rejecting the
    plain values x 1.001 and zeros, for the ``mm`` bodies the plain
    values computed with TF32 allowed, and for jacobi2d the plain values
    moved by one lane; each span launched twice on the same input, equal
    bit for bit; per block the kernel (its calls back to back, which a
    short span's host launch sets, and its device time alone,
    ``device_ms``), its plain version, the library call
    ``torch.addmm``/``mm``/``mv``/``addmv`` where one computes the
    block's values, ``F.conv2d`` with the five-point cross for
    ``jacobi2d`` (its interior columns; null for ``gesummv`` and
    ``syr2k``; timed both ways too) and
    the bound: each env array read once and each output written once at
    3.35 TB/s, or the span's operations — a product's 2·M·N·K three times
    over at 495 TFLOP/s (TF32, dense) where it runs 3xTF32, else at the
    67 TFLOP/s float32 rate (both printed); the kernel's sums of these
    over its blocks, and ``Compiled.run`` per lowering.  Per block it
    also prints K1's launch (``span_kernel.launch_span``: one C call into
    the compiled kernel) beside Triton's own launch path
    (``launch_span_triton``): host enqueue, back to back and device;
18. **repairs** — programs K1 and K2 once refused, at EXTRALARGE-scale
    rows, float32, seeded normal data: ``cumsum`` along a row on rank 1
    (8 ranks: 2000 rows of 2600, consumed whole, rolled, by a product
    with a 2600 x 2600 matrix, reduced and at one position) and rank 2
    (a 4x2 mesh: 200 x 200 rows of 512), ``roll`` of a lane scalar on
    rank 1 (N = 2^24) and rank 2 (4096 x 4096), and a region whose two
    later stages roll a row of 1000 that its first stage forwards in a
    register tile (16384 rows, one span of 3 stages); the bodies K1's
    template once refused: pointwise math (``sin`` .. ``erf``,
    ``pow``, rounding, ``sign``, ``clamp``; N = 2^24), ``cumprod`` along
    rows of 2600 (rolled, tiled), a gather through per-lane index vectors
    of 4 with negative and out-of-range entries (N = 2^24), the values of
    a sort of 512-wide rows (16384 rows; ``torch.sort`` its library call)
    and a row of 4096 a later stage re-loads after a barrier (8192 rows,
    stored tile by tile); the ninth slice's ``logcumsumexp`` and the
    values of ``cummax``/``cummin`` along 2000 rows of 2600, the indices
    of a sort of 16384 tied rows of 512 and an int32 ``x ** 5`` (N =
    2^24), each beside its one ``torch`` call; the tenth slice's
    product one column wide (2000 rows of 2600 times a one-column slice)
    and int32 product (2000 x 2600 by 2600 x 64, wrapping; its plain
    version on the host: torch has no CUDA int32 product), integers
    held bit for bit: each under
    ``lowering="kernel"`` against its shared-memory run (``agree`` at
    1e-4: a scan of 2600 normal values reaches ~100, where two float32
    sums in another order differ by more than a fixed 1e-4),
    K1's launches per run, its spans against their plain versions
    (``agree``/``agree_rows`` and their rejections; the region's on
    seeded normal data, rejecting a one-lane move) and times; then K2 at
    head_dim 288 and 512 (the wide kernel), B=1, H=4, KV=1, S=4096,
    causal, bfloat16 and float32, against its plain version (phase 6's
    checks), its launches, times, SDPA and the bound;
19. **master/worker** (paper Fig. 1b) — ``pi`` and ``jacobi1d`` (N =
    2^24) and the PolyBench kernels of phase 17 at EXTRALARGE size on 8
    virtual ranks under ``lowering="master_worker"``, the master
    excluded and included, and as a region staged per loop: every output
    equal to ``run_reference`` (1e-4; ``PB_MM_TOL`` on products); the
    mesh's ppermute launches and bytes equal to ``mw_messages`` (the
    reference executor's sends, held to it in
    ``tests/test_torch_master_worker.py``); K1 launches none;
    ``Compiled.run`` timed under master/worker, collective and kernel;
20. **runtime** — (a) ``ResilientExecutor`` over ``jacobi1d`` (N = 2^24,
    collective) and PolyBench ``gemm`` (EXTRALARGE, kernel lowering) on 8
    ranks, a ``FaultPlan`` losing rank 3: the run recovered onto 7 ranks
    equals the healthy one (bit for bit; ``PB_MM_TOL`` on gemm's
    product), K1 launches on the shrunk mesh and its span is held against
    its plain version and timed (a kernel-table row); recovery timed cold
    and warm (a second executor hitting the compile cache) and the
    degraded run; (b) a NaN at ``run_exit`` caught and absorbed by a
    retry; (c) 16 threads, one cold program, a ``CompileService``: one
    compile; (d) a straggler with ``device_weights`` escalates to one
    weighted recompile whose outputs equal the unweighted ones;
21. **the persistent compile store** — PolyBench ``gemm`` (kernel) and
    ``jacobi1d`` (collective) on 8 ranks in four fresh processes (no
    store, an empty store, a hit, a hit with an empty Triton cache),
    each first ``Compiled.run`` timed; hits restore every block, the
    last compiles nothing through Triton, outputs equal bit for bit
    (``aot_phase``);
22. **qwen2-moe-a2.7b** at full width and depth, bfloat16 weights drawn
    on the card: the prefill of 2 x 4096 tokens with K2 (24 launches)
    against the plain prefill on the tokens whose routing agrees, the
    share of routing flips, times, tokens/s and the profiler's split
    (K2, expert products, dispatch, the rest); float32 at
    ``MOE_F32_LAYERS`` layers; K2 at its shape against its plain
    version, SDPA and the bound (``moe_phase``);
23. **MoE serving** — phase 8's engine and check on qwen2-moe-a2.7b at
    capacity factor ``MOE_SERVE_CF``;
24. **jamba-1.5-large-398b and arctic-480b** at ``smoke_config`` size:
    prefill + one decode step == forward at capacity factor 8, and the
    engine serves 3 requests (``moe_smoke_phase``);
25. **whisper-small** at full width and depth (``whisper_phase``): 4
    requests of 1500 frames and 4-64 prompt tokens, the kernel prefill
    (K2 for the encoder's bidirectional attention, the decoder's causal
    self-attention and its cross-attention) against impl="full" in
    float32 and bfloat16, K2's launches per encode / prefill / decode
    step, 32 greedy decode steps against a teacher-forced reference,
    times;
26. **K2 at whisper's three shapes** (``whisper_k2_rows``): Sq = Sk =
    1500, Sq 64 / Sk 1500, Sq 1 / Sk 1500, no mask, hd 64, bfloat16 and
    float32, against the plain version, timed beside SDPA and the bound;
27. **training** (``train_phase``): one float32 train step of gemma3-1b
    at full width and 2 layers on the card against the same step on the
    host; gemma3-1b and whisper-small at full width and depth, 30 steps
    on one repeated 8 x 256 batch (AdamW, remat, bf16 compute): the loss
    falls to at most ``TRAIN_LOSS_SHARE`` of the first, ms per step and
    tokens/s; a ``FaultTolerantLoop`` run with a planted failure and a
    restore equal to an uninterrupted run, bit for bit, in a fresh
    process under deterministic algorithms (``ft_child``).
28. **training across ranks** (``mesh_train_phase``): gemma3-1b at full
    width on the stacked mesh (every rank on the card), (a) at 2 layers
    one float32 step on a (2, 2) mesh with ZeRO-3 (the batch's rows
    split over ``data``, parameters and AdamW state stored as per-rank
    blocks over ``data`` and ``model``, gathered before the forward,
    gradients summed by ``psum``) against the (1, 1) step on the same
    batch, ``agree`` at ``MESH_STEP_TOL``; (b) at full depth, bf16
    compute, remat, 12 steps on one 8 x 256 batch on (1, 1) and (2, 2):
    the first 3 losses within ``MESH_LOSS_SHARE``, all 12 within
    ``MESH_LOSS_SHARE_ALL``, ms per step on both (median
    of the last 10) and their ratio, the mesh's collectives and bytes
    per step;
29. **MoE groups across ranks** (``moe_mesh_phase``): qwen2-moe-a2.7b at
    full width and 2 layers, float32, Adafactor, on a (2, 1) mesh (each
    rank's rows one dispatch group of 2) against a one-rank step at
    groups 2: every token's routing equal, then the step under
    ``agree`` at ``MOE_STEP_TOL``;
30. **GPipe** (``gpipe_phase``): whisper-small's 12 encoder blocks as 4
    stages of 3 on a 4-rank stacked mesh, 4 microbatches of one
    utterance of 1500 frames: bf16 with K2 == the blocks in order with
    impl="full" (``PREFILL_TOL_BF16``), M+S-1 ``ppermute`` launches and
    S x 3 x (M+S-1) K2 launches per forward; float32 with the plain
    attention and checkpointed stages: outputs and gradients == the
    blocks in order under autograd (``GPIPE_F32_TOL``); ms per pipeline
    forward beside the blocks in order; K2 on the q, k, v of a launch
    inside a tick against its plain version, timed (a kernel-table row);
31. **the int8 all-reduce** (``allreduce_phase``):
    ``compressed_allreduce_tree`` over 4 data ranks of gemma3-1b's
    gradient shapes: every leaf's mean within its two-hop int8 bound of
    the float mean, its counted bytes against a float ``psum``'s;
32. **the train_lm example** (``train_lm_phase``): ``python -m
    repro_torch.examples.train_lm --steps 200`` on the card in a fresh
    process passes its learning check.

In phases 4, 15, 17 and 18 every span is also launched by K1's launcher
and by Triton's launch path on the same feeds, equal bit for bit.

The last two lines are the kernel table as one JSON object and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
FP32_FLOPS_PER_S = 67e12       # H100 SXM float32 rate outside tensor cores
TF32_FLOPS_PER_S = 495e12      # H100 SXM TF32 tensor-core rate, dense
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


def host_ms(fn, reps=3) -> float:
    """Milliseconds of one host call of ``fn`` (the median of ``reps``)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


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

    # the same product as torch.dot: the rank-2 outer tile on tl.dot
    @omp.parallel_for(start=(1, 0), stop=(41, 37), collapse=2, name="dot2")
    def dot2(i, j, env):
        return {"C": omp.at((i, j), torch.dot(env["A"][i], env["B"][:, j]))}
    out.append((dot2, {"A": rnd(42, 70), "B": rnd(70, 37),
                       "C": -torch.ones(42, 37, device=dev)}))

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
        (got,) = span_kernel.span_stage_values(
            one_stage(kernel_lower, comp.plan, prog, slabs, repl),
            span.source, mesh.device)
        want = span_kernel.span_values_plain(comp.plan, prog, slabs, repl,
                                             mesh.device)
        err = max(err, hold_lanes(torch, got, want, mask,
                                  span_tol(span.source), label))
        hold_launch_bits(torch, kernel_lower, span_kernel, span.source,
                         one_stage(kernel_lower, comp.plan, prog, slabs,
                                   repl), mesh.device, label)
    print(f"kernel-vs-plain {label}: {len(comp.kernel_plan.spans)} span(s) "
          f"max_abs_err={err:.3e}; K1's launcher == Triton's launch path "
          "bit for bit")
    return err


def one_stage(kernel_lower, plan, prog, slabs, repl) -> list:
    """A block's span as the executor hands it to the wrapper: one
    stage."""
    return [kernel_lower.SpanStage(plan=plan, program=prog,
                                   ext_windows=slabs, env_repl=repl)]


def span_tol(source) -> float:
    """1e-5 for pointwise bodies; 1e-4 where a body sums a value axis
    (``tl.sum``, a scan's ``tl.cumsum``), multiplies a row's values
    (``tl.cumprod``) or matrices (``tl.dot``), in another order, or calls
    a transcendental function whose CUDA version lies further than a few
    ulp from torch's (libdevice's, ``tl.sin`` and the like)."""
    return 1e-4 if any(op in source.text for op in (
        "tl.sum(", "tl.dot(", "tl.cumsum(", "tl.cumprod(", "libdevice.",
        "tl.sin(", "tl.cos(", "tl.erf(", "tl.sigmoid(", "tl.rsqrt(")) \
        else 1e-5


def hold_launch_bits(torch, kernel_lower, span_kernel, source, stages, dev,
                     label) -> int:
    """The span launched by K1's launcher (``launch_span``: one C call
    into the compiled kernel) and by Triton's own launch path
    (``launch_span_triton``) on the same feeds: every output equal bit
    for bit on the lanes that hold an iteration (the same cubin runs).
    Returns the number of arrays compared."""
    io = [(st.ext_windows, st.env_repl) for st in stages]
    new = span_kernel.launch_span(source, io, dev)
    old = span_kernel.launch_span_triton(source, io, dev)
    n = 0
    for st, a, b in zip(stages, new, old):
        mask = kernel_lower.lane_mask(st.plan, dev)
        for k in b:
            if not torch.equal(a[k][mask], b[k][mask]):
                raise AssertionError(
                    f"{label} {k}: K1's launcher != Triton's launch path "
                    "bit for bit")
            n += 1
    return n


def hold_lanes(torch, got, want, mask, tol, label, lane_dim=None) -> float:
    """Every key's dense values under ``agree`` on the lanes ``mask``
    selects (those holding an iteration; the kernel writes no other), and
    the same check shown to reject the plain values scaled by 1.001 and
    all zeros — and, given ``lane_dim`` (the dense layout's innermost
    lane axis), the plain values moved by one lane along it inside each
    chunk, which is what a forward served from the neighbouring lane's
    tile would give (keys equal under that move are skipped: no lane
    fault shows there).  Returns the max abs error."""
    err = 0.0
    for k in want:
        g, w = got[k][mask], want[k][mask]
        if not w.is_floating_point():
            # integers (a sort's indices, a wrapped pow) equal bit for bit:
            # any other value fails, so no rejection needs showing
            if not torch.equal(g, w):
                raise AssertionError(
                    f"{label} {k}: kernel != plain at "
                    f"{int((g != w).sum())} of {w.numel()} integers")
            continue
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
        if lane_dim is not None:
            # lane l's values held at lane l + 1 of the same chunk
            c = mask.shape[lane_dim] - 1
            both = mask.narrow(lane_dim, 0, c) & mask.narrow(lane_dim, 1, c)
            here = want[k].narrow(lane_dim, 0, c)[both]
            moved = want[k].narrow(lane_dim, 1, c)[both]
            if not torch.equal(moved, here) and agree(torch, moved, here,
                                                      tol):
                raise AssertionError(f"{label} {k}: the check at tol={tol} "
                                     "cannot tell a read of the "
                                     "neighbouring lane")
        err = max(err, e)
    return err


# ---------------------------------------------------------------------------
# K2: flash attention
# ---------------------------------------------------------------------------


def k2_cases(torch):
    """(label, b, h, kv, sq, sk, hd, causal, window, dtype, tol): the 7
    cases of tests/test_kernels.py in their own types (float32, the
    ragged case float16) and each again in bfloat16; a head_dim of 72 (a
    multiple of 8, not of 16) in bfloat16 and float32; a head_dim of 100
    (padded to 104 by the wrapper) in bfloat16 and float32; a ragged head_dim
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
    for dt in (bf16, f32):
        # not a multiple of 8: the wrapper pads it with zero columns
        cases.append(("hd100", 1, 4, 2, 130, 150, 100, True, 64, dt,
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


def k2_bound(torch, b, h, kv, sq, sk, hd, window, dtype, causal=True):
    """(bound in s, what bounds it, flops, bytes, allowed pairs per
    head) of one K2 call at these shapes."""
    pairs = band_pairs(sq, sk, causal, window)
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


def device_ms(torch, fn, reps=REPS, inner=INNER) -> tuple[float, float]:
    """Milliseconds of device time per call of ``fn`` (every kernel, copy
    and fill it runs), and the host's milliseconds per call to enqueue
    it.  Each of ``reps`` runs holds the card in ``torch.cuda._sleep``
    for twice the host's time to enqueue ``inner`` calls, so that the
    calls and the two events around them queue up behind it and then run
    back to back: the events then time the card, not the host's launch
    rate (which sets ``cuda_ms`` for a short kernel).  The median run."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / inner
    torch.cuda.synchronize()
    # at most 2 GHz: 2e6 cycles a millisecond lasts at least that long
    cycles = int(2 * host_ms * inner * 2e6) + 100_000
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times), host_ms


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


def launch_turns(torch, ways, turns=2) -> dict:
    """Each way of launching one span timed in turns (the first way, the
    second, the first, ...): back to back (:func:`cuda_ms`), then device
    time and host enqueue (:func:`device_ms`); per way the median of its
    turns, as ``{way: (back_to_back_ms, device_ms, host_ms)}``."""
    got = {w: ([], [], []) for w in ways}
    for _ in range(turns):
        for w, fn in ways.items():
            got[w][0].append(cuda_ms(torch, fn))
            for v, m in zip(device_ms(torch, fn), got[w][1:]):
                m.append(v)
    return {w: tuple(statistics.median(v) for v in m)
            for w, m in got.items()}


def k3_long_chunk_cases(torch):
    """(label, b, s, h, p, n, chunk, dtype): a chunk over the kernel's
    256 (``ssd_scan.MAX_CHUNK``), which runs as 256 and must still equal
    the plain version, in float32 and bfloat16."""
    return [("chunk512", 1, 1100, 2, 32, 16, 512, dtype)
            for dtype in (torch.float32, torch.bfloat16)]


def k3_inputs(torch, dev, b, s, h, p, n, dtype, seed):
    """x, dt, A, Bm, Cm drawn as tests/test_kernels.py draws them."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x = rnd(b, s, h, p).to(dtype)
    dt = rnd(b, s, h).abs() * 0.1
    A = -rnd(h).abs() - 0.1
    return x, dt, A, rnd(b, s, n).to(dtype), rnd(b, s, n).to(dtype)


def check_k3(torch, ssd, args, chunk, tol, label) -> tuple[float, float,
                                                          float]:
    """K3 against its plain version on the same inputs, its counter moving
    once: under ``hold`` (whole-tensor scale) and ``hold_rows`` (each row
    of P at its own scale); returns the max abs error, max|plain| and the
    worst row-relative error."""
    before = ssd.LAUNCHES
    got = ssd.ssd_scan_kernel(*args, chunk=chunk)
    torch.cuda.synchronize()
    if ssd.LAUNCHES != before + 1:
        raise AssertionError(f"K3 {label}: {ssd.LAUNCHES - before} "
                             "launches counted, want 1")
    want = ssd.ssd_scan_plain(*args)[0]
    err, scale = hold(torch, got, want, tol, f"K3 {label}: kernel != plain")
    worst = hold_rows(torch, got, want, tol,
                      f"K3 {label}: kernel != plain, row by row")
    return err, scale, worst


def k3_phase(torch, dev):
    """Phase 10: every K3 case against the plain version; returns the max
    abs error by (label, type)."""
    from repro_torch.kernels import ssd_scan as ssd

    errs = {}
    for i, (label, b, s, h, p, n, chunk, dtype) in enumerate(
            k3_cases(torch) + k3_long_chunk_cases(torch)):
        args = k3_inputs(torch, dev, b, s, h, p, n, dtype, i)
        tname = dtname(dtype)
        tol = K3_TOL[tname]
        err, scale, worst = check_k3(torch, ssd, args, chunk, tol,
                                     f"{label} {tname}")
        errs[label, tname] = err
        print(f"K3-vs-plain {label}: B={b} S={s} H={h} P={p} N={n} "
              f"chunk={chunk} {tname} max_abs_err={err:.3e} (tol {tol}, "
              f"max|plain| {scale:.3e}); rows of P: worst |err| / "
              f"(|plain| + row RMS) {worst:.3e}")
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
        worst_row = (0.0, 0)
        for layer, (got, (_, _, want)) in enumerate(zip(outs, calls)):
            label = (f"prefill {tname} layer {layer}: ops.ssd_scan != "
                     "ssd_chunked")
            err, scale = hold(torch, got, want, tol, label)
            worst = max(worst, (err / (scale or 1.0), layer))
            worst_row = max(worst_row, (hold_rows(
                torch, got, want, tol, f"{label}, row by row"), layer))
        print(f"prefill {cfg.name} {tname}: ops.ssd_scan (K3 + D*x) == "
              f"ssd_chunked on the activations of all {cfg.n_layers} layers "
              f"(rtol={tol}, atol={tol} x max|value|; worst err / scale "
              f"{worst[0]:.3e} in layer {worst[1]}; rows of P held at tol "
              f"x (|value| + row RMS): worst {worst_row[0]:.3e} in layer "
              f"{worst_row[1]}); K3 launches: "
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
    profile_run(torch, lambda: run(bf16), card, wall[bf16],
                f"prefill {cfg.name} bfloat16")
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
              f"per call: 5 CUDA grids; chunk {chunk}), plain "
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
    profile_run(torch, lambda: run("kernel", bf16), card,
                prefill_ms["kernel", bf16],
                f"prefill {cfg.name} bfloat16 impl=kernel", ("K2", "flash_fwd"))
    return model, params, launches


def profile_run(torch, fn, card, wall_ms, label, kernel=None):
    """One run (``fn()``: a prefill, a region's ``Compiled.run``) under
    ``torch.profiler``: its kernels' busy time against ``wall_ms`` (the
    same run timed without the profiler, whose own overhead stretches the
    wall time it sees), the share of the port's kernel ``kernel`` =
    (name, substring of its CUDA kernels' names) where given, and the
    kernels that take the most."""
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
        print(f"profile {label}: the profiler recorded no device time")
        return
    share = ""
    if kernel is not None:
        mine = [e for e in kernels if kernel[1] in e.key]
        ms = sum(e.self_device_time_total for e in mine) / 1e3
        share = (f"; {kernel[0]} {ms:.2f} ms ({ms / busy_ms:.1%} of kernel "
                 f"time, {sum(e.count for e in mine)} launches)")
    print(f"profile {label}: kernels busy {busy_ms:.2f} ms, "
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


def prefill_pairs(got, want, names=("k", "v"), tokens=None):
    """(name, got, want) over two prefills' logits and every layer's cache
    entries ``names``, as float32; ``slot*`` caches are split by period,
    so ``cache slot1[p]`` is layer ``p x period + 1``.  Given ``tokens``
    ((B, S) bool), only those tokens' cache rows, and the logits of the
    prompts whose last token is one of them."""
    (got_logits, got_cache), (want_logits, want_cache) = got, want
    pairs = []
    if tokens is None:
        pairs.append(("logits", got_logits, want_logits))
    elif bool(tokens[:, -1].any()):
        last = tokens[:, -1]
        pairs.append(("logits", got_logits[last], want_logits[last]))
    for key in want_cache:
        for name in names:
            g, w = got_cache[key][name], want_cache[key][name]
            if key.startswith("slot"):
                layers = [(f"cache {key}[{i}]/{name}", g[i], w[i])
                          for i in range(w.shape[0])]
            else:
                layers = [(f"cache {key}/{name}", g, w)]
            pairs += [(n, a, b) if tokens is None else (n, a[tokens],
                                                         b[tokens])
                      for n, a, b in layers]
    return [(n, g.float(), w.float()) for n, g, w in pairs]


def worst_gap(pairs):
    """The largest max abs err / max |want| of ``pairs``, and its name."""
    return max(((g - w).abs().max().item() / (w.abs().max().item() or 1.0),
                name) for name, g, w in pairs)


def hold_pairs(torch, pairs, tol, label):
    """Every (name, got, want) pair under ``agree`` at ``tol``; returns
    :func:`worst_gap`.  Every reading is taken before a failure raises,
    so a failure names them all."""
    worst = worst_gap(pairs)
    bad = [name for name, g, w in pairs if not agree(torch, g, w, tol)]
    if bad:
        raise AssertionError(
            f"{label} at rtol={tol}, atol={tol} x max|value| in "
            f"{', '.join(bad)}; worst err / scale {worst[0]:.3e} in "
            f"{worst[1]}")
    return worst


def hold_prefill(torch, got, want, tol, label, names=("k", "v"),
                 tokens=None):
    """A prefill's (logits, cache) under ``agree`` against another's, the
    cache's positions equal where it keeps them; returns
    :func:`worst_gap` of the logits and every layer's cache entries
    ``names`` (on ``tokens`` only, given: see :func:`prefill_pairs`),
    held by :func:`hold_pairs`."""
    for key in want[1]:
        if "pos" in want[1][key] and not torch.equal(got[1][key]["pos"],
                                                     want[1][key]["pos"]):
            raise AssertionError(f"{label}: cache {key}/pos differ")
    return hold_pairs(torch, prefill_pairs(got, want, names, tokens), tol,
                      label)


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


# ---------------------------------------------------------------------------
# Regions: whole programs through the fused, staged and kernel lowerings
# ---------------------------------------------------------------------------

N_REGION = 1 << 24             # rank-1 region programs
REGION_CHUNK = 1 << 16         # static(2^16): 32 chunks per rank at 8 ranks
REGION2_CHUNK = 256            # heat2d_region: static(256) on both axes
REGION_LOWERINGS = {
    "fused": dict(),                           # comm auto, aggregate
    "fused_inline": dict(comm_schedule="inline"),
    "fused_gather": dict(comm="gather"),
    "collective": dict(lowering="collective"),
    "kernel": dict(lowering="kernel"),
}
REGION_LIBRARY_NOTE = ("no single PyTorch call computes a chain of loop "
                       "bodies")


def jacobi_chain_region(omp, torch, dev, n=N_REGION):
    """``benchmarks/region_chains.py::make_jacobi_chain``: two pointwise
    sweeps and a ``+`` reduction, every hand-off resident (ONE span)."""
    @omp.parallel_for(stop=n, name="sweep1")
    def sweep1(i, env):
        return {"u": omp.at(i, env["a"][i] * 0.5 + 1.0)}

    @omp.parallel_for(stop=n, name="sweep2")
    def sweep2(i, env):
        return {"v": omp.at(i, env["u"][i] * env["u"][i])}

    @omp.parallel_for(stop=n, reduction={"norm": "+"}, name="norm")
    def norm(i, env):
        return {"norm": omp.red(env["v"][i])}

    env = {"a": torch.arange(n, dtype=torch.float32, device=dev),
           "u": torch.zeros(n, device=dev), "v": torch.zeros(n, device=dev),
           "norm": torch.zeros((), device=dev)}
    return (omp.region(sweep1, sweep2, norm, name="jacobi_chain"), env,
            (8,), ("data",))


def _pingpong(omp, names, n, c, fields, sweeps, region_name):
    a_names = tuple(f"a{k}" for k in range(fields)) if fields else ("a",)
    b_names = tuple(f"b{k}" for k in range(fields)) if fields else ("b",)

    def sweep(srcs, dsts, name):
        @omp.parallel_for(start=1, stop=n - 1, schedule=omp.static(c),
                          name=name)
        def body(i, env):
            return {d: omp.at(i, 0.25 * (env[s][i - 1] + 2.0 * env[s][i]
                                         + env[s][i + 1]))
                    for s, d in zip(srcs, dsts)}
        return body

    stages, cur, nxt = [], a_names, b_names
    for k in range(sweeps):
        stages.append(sweep(cur, nxt, f"{names}{k + 1}"))
        cur, nxt = nxt, cur
    return omp.region(*stages, name=region_name), a_names, b_names


def heat3_region(omp, torch, dev, n=N_REGION, c=REGION_CHUNK):
    """``benchmarks/stencil_halo.py::make_heat_chain``: three ping-pong
    3-point sweeps with a halo exchange between each (three spans)."""
    reg, _, _ = _pingpong(omp, "sweep", n, c, 0, 3, "heat3")
    x = torch.arange(n, dtype=torch.float32, device=dev)
    env = {"a": torch.sin(x * 0.01), "b": torch.zeros(n, device=dev)}
    return reg, env, (8,), ("data",)


def multifield_region(omp, torch, dev, n=N_REGION, c=REGION_CHUNK):
    """``benchmarks/stencil_halo.py::make_multifield_chain``: 3 fields x
    5 sweeps, every boundary carrying 3 buffers on one ring (the
    aggregation case)."""
    reg, a_names, b_names = _pingpong(omp, "mf", n, c, 3, 5, "multifield")
    x = torch.arange(n, dtype=torch.float32, device=dev)
    env = {k: torch.sin((j + 1) * x * 0.01) for j, k in enumerate(a_names)}
    env.update({k: torch.zeros(n, device=dev) for k in b_names})
    return reg, env, (8,), ("data",)


def heat2d_region(omp, torch, dev, n=N2, c=REGION2_CHUNK):
    """``benchmarks/heat2d.py::make_heat2d_chain``: three 5-point
    ``collapse(2)`` sweeps a -> b -> a -> b over a 4x2 mesh."""
    def sweep(src, dst, name):
        @omp.parallel_for(start=(1, 1), stop=(n - 1, n - 1), collapse=2,
                          schedule=omp.static(c), name=name)
        def body(i, j, env):
            v = 0.25 * (env[src][i - 1, j] + env[src][i + 1, j]
                        + env[src][i, j - 1] + env[src][i, j + 1])
            return {dst: omp.at((i, j), v)}
        return body

    reg = omp.region(sweep("a", "b", "sweep1"), sweep("b", "a", "sweep2"),
                     sweep("a", "b", "sweep3"), name="heat2d_region")
    x = torch.arange(n * n, dtype=torch.float32, device=dev)
    env = {"a": torch.sin(x * 0.01).reshape(n, n),
           "b": torch.zeros(n, n, device=dev)}
    return reg, env, (4, 2), ("i", "j")


def pipeline_region(omp, torch, dev, n=N_REGION):
    """``examples/region_pipeline.py``: sweep, square, sum of squares,
    serial glue (scale = 1/sqrt(sum)), normalize — the glue breaks the
    spans."""
    @omp.parallel_for(stop=n, name="sweep")
    def sweep(i, env):
        return {"u": omp.at(i, env["a"][i] * 0.5 + 1.0)}

    @omp.parallel_for(stop=n, name="square")
    def square(i, env):
        return {"v": omp.at(i, env["u"][i] * env["u"][i])}

    @omp.parallel_for(stop=n, reduction={"ss": "+"}, name="sumsq")
    def sumsq(i, env):
        return {"ss": omp.red(env["v"][i])}

    rescale = omp.serial(
        lambda env: {"scale": 1.0 / torch.sqrt(env["ss"] + 1e-6)[None]},
        reads=("ss",), name="rescale")

    @omp.parallel_for(stop=n, name="normalize")
    def normalize(i, env):
        return {"y": omp.at(i, env["v"][i] * env["scale"][0])}

    env = {"a": torch.arange(n, dtype=torch.float32, device=dev) / n,
           "u": torch.zeros(n, device=dev), "v": torch.zeros(n, device=dev),
           "ss": torch.zeros((), device=dev),
           "scale": torch.zeros(1, device=dev),
           "y": torch.zeros(n, device=dev)}
    return (omp.region(sweep, square, sumsq, rescale, normalize,
                       name="pipeline"), env, (8,), ("data",))


def region_programs(omp, torch, dev):
    return {name: make(omp, torch, dev) for name, make in (
        ("jacobi_chain", jacobi_chain_region), ("heat3", heat3_region),
        ("multifield", multifield_region), ("heat2d_region", heat2d_region),
        ("pipeline", pipeline_region))}


def record_spans(span_kernel, run):
    """Run ``run()`` with the span wrapper recording every span's stage
    feeds and source as the executor hands them over."""
    calls = []
    wrapper = span_kernel.span_stage_values

    def record(stages, source, device):
        calls.append((list(stages), source))
        return wrapper(stages, source, device)

    span_kernel.span_stage_values = record
    try:
        run()
    finally:
        span_kernel.span_stage_values = wrapper
    return calls


def compare_region_spans(torch, kernel_lower, span_kernel, calls, dev,
                         label) -> float:
    """Every span's kernel (one launch for all its stages) against the
    multi-stage plain version on the same feeds, stage by stage, on the
    lanes that hold an iteration, with ``hold_lanes``' rejections of a
    neighbouring lane's values; returns the max abs error."""
    err = 0.0
    for stages, source in calls:
        got = span_kernel.launch_span(
            source, [(st.ext_windows, st.env_repl) for st in stages], dev)
        want = span_kernel.span_values_plain_stages(stages, dev)
        for st, g, w in zip(stages, got, want):
            err = max(err, hold_lanes(
                torch, g, w, kernel_lower.lane_mask(st.plan, dev),
                span_tol(source), f"{label} span {source.fn_name} stage "
                f"{st.plan.name}", lane_dim=3 * st.plan.rank - 1))
        hold_launch_bits(torch, kernel_lower, span_kernel, source, stages,
                         dev, f"{label} span {source.fn_name}")
    return err


def random_env(torch, env, seed):
    """``env``'s keys, shapes and types filled with seeded normal values:
    neighbouring lanes differ by O(1), so a lane fault shows at any
    tolerance (on a program's own smooth data, such as an ``arange``, a
    neighbour differs by less than float32 resolves)."""
    g = torch.Generator(device=env[next(iter(env))].device).manual_seed(seed)
    return {k: torch.randn(v.shape, generator=g, device=v.device,
                           dtype=v.dtype) for k, v in env.items()}


def check_region_spans(torch, kernel_lower, span_kernel, comp, env, dev,
                       label, seed=0):
    """Record the spans of one kernel-lowered run of ``comp`` on seeded
    random data of ``env``'s shapes, check that every planned span was
    recorded, and hold each against its plain version.  Returns
    ``(calls, max abs error)``."""
    calls = record_spans(span_kernel, lambda: comp(random_env(torch, env,
                                                              seed)))
    n = comp.kernel_plan.n_kernels
    if len(calls) != n or n == 0:
        raise AssertionError(f"{label}: recorded {len(calls)} span calls, "
                             f"planned {n}")
    return calls, compare_region_spans(torch, kernel_lower, span_kernel,
                                       calls, dev, label)


def span_bound(torch, stages, source):
    """(bytes, flops) the span must move and do: each env array its
    stages read from outside the span, once; each stage's outputs on the
    loop's iterations, once (forwarded intermediates are stored, so they
    count as outputs, never as reads)."""
    nbytes, seen = 0, set()
    for _, si, key in source.inputs:
        if key not in seen:
            seen.add(key)
            info = stages[si].plan.context.vars[key]
            nbytes += math.prod(info.shape) * torch.empty(
                (), dtype=info.dtype).element_size()
    trip = stages[0].plan.nest.total_trip
    for si, _, shape, dt in source.outputs:
        rank = stages[si].plan.rank
        nbytes += trip * math.prod(shape[3 * rank:]) * torch.empty(
            (), dtype=dt).element_size()
    return nbytes, source.flops_per_lane * trip


def region_phase(torch, dev, card):
    """Phases 14-16: every region program under every lowering against
    its shared-memory run on the card; the mesh's counters; K1's launches
    per run; each span's kernel against its plain version; times.
    Returns the kernel-table rows."""
    from repro_torch import omp
    from repro_torch.core import kernel_lower
    from repro_torch.kernels import span_kernel

    rows = []
    for name, (reg, env, shape, axes) in region_programs(
            omp, torch, dev).items():
        mesh = omp.make_mesh(shape, axes, device=dev)
        ref = reg(env)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comps = {low: omp.compile(reg, mesh, env_like=env, **opts)
                 for low, opts in REGION_LOWERINGS.items()}
        kp = comps["kernel"].kernel_plan
        outs, counts = {}, {}
        for low, comp in comps.items():
            comp(env)                   # first run: builds K1's kernels
            torch.cuda.synchronize()
            mesh.reset_counters()
            span_kernel.LAUNCHES = 0
            outs[low] = comp(env)
            torch.cuda.synchronize()
            counts[low] = (dict(mesh.launches), dict(mesh.bytes),
                           span_kernel.LAUNCHES)
            for k in ref:
                torch.testing.assert_close(
                    outs[low][k], ref[k], rtol=1e-4, atol=1e-4,
                    msg=lambda m: f"region {name}/{low} {k}: {m}")
                if not bool(torch.isfinite(outs[low][k]).all()):
                    raise AssertionError(f"region {name}/{low} {k}: "
                                         "not finite")
        for agg, inl in (("fused", "fused_inline"),):
            for k in ref:
                if not torch.equal(outs[agg][k], outs[inl][k]):
                    raise AssertionError(
                        f"region {name} {k}: aggregate != inline bit for "
                        "bit")
        launches = counts["kernel"][2]
        if launches != kp.n_kernels or any(
                counts[low][2] for low in comps if low != "kernel"):
            raise AssertionError(
                f"region {name}: K1 launched {launches} times under "
                f"lowering=kernel (planned {kp.n_kernels} spans), "
                f"{[counts[low][2] for low in comps]} by lowering")
        pp = {low: (counts[low][0].get("ppermute", 0),
                    counts[low][1].get("ppermute", 0))
              for low in ("fused", "fused_inline")}
        if pp["fused"][1] != pp["fused_inline"][1]:
            raise AssertionError(f"region {name}: aggregate moves "
                                 f"{pp['fused'][1]} ppermute bytes, inline "
                                 f"{pp['fused_inline'][1]}")
        if name == "multifield" and not (
                pp["fused_inline"][0] >= 2 * pp["fused"][0] > 0):
            raise AssertionError(f"region {name}: inline {pp['fused_inline']}"
                                 f" vs aggregate {pp['fused']} ppermutes: "
                                 "want >= 2x fewer launches aggregated")
        shapes = {k: tuple(v.shape) for k, v in outs["kernel"].items()
                  if k in comps["fused"].plan.touched_keys}
        print(f"region {name}: {len(reg.stages)} stages on a "
              f"{'x'.join(map(str, shape))} mesh, compiled 5 ways in "
              f"{time.perf_counter() - t0:.2f} s; fused (auto/aggregate, "
              "auto/inline, gather), collective and kernel == prog(env) "
              "(rtol=atol=1e-4), aggregate == inline bit for bit; "
              f"spans {[len(sp.stage_indices) for sp in kp.spans]}, K1 "
              f"launches per run {launches} (planned {kp.n_kernels}); "
              f"outputs {shapes}")
        for low in comps:
            print(f"  mesh counters {name}/{low}: launches "
                  f"{counts[low][0]} bytes {counts[low][1]}")

        calls, err = check_region_spans(torch, kernel_lower, span_kernel,
                                        comps["kernel"], env, dev,
                                        f"region {name}")
        print(f"kernel-vs-plain region {name} (seeded normal data): "
              f"{len(calls)} span(s), "
              f"stages {[len(st) for st, _ in calls]}, forwarded "
              f"{[list(src.forwarded) for _, src in calls]}, "
              f"max_abs_err={err:.3e}")

        ms = plain_ms = bound_s = 0.0
        nbytes = flops = 0
        for stages, source in calls:
            io = [(st.ext_windows, st.env_repl) for st in stages]
            k_ms = cuda_ms(torch, lambda: span_kernel.launch_span(
                source, io, dev))
            p_ms = cuda_ms(torch, lambda: span_kernel.
                           span_values_plain_stages(stages, dev),
                           reps=5, inner=2, warmup=1)
            b, f = span_bound(torch, stages, source)
            b_s = max(b / HBM_BYTES_PER_S, f / FP32_FLOPS_PER_S)
            print(f"  times span {'+'.join(st.plan.name for st in stages)} "
                  f"of {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                  f"bound {b_s * 1e3:.4f} ms ({b} B, {f} flops), library "
                  f"null ({REGION_LIBRARY_NOTE}) on {card}")
            ms, plain_ms, bound_s = ms + k_ms, plain_ms + p_ms, bound_s + b_s
            nbytes, flops = nbytes + b, flops + f
        del calls
        bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                    >= flops / FP32_FLOPS_PER_S else "operations")
        rows.append({
            "name": f"span_kernel[region {name}]", "route": "triton",
            "source": SOURCE, "replaces": REPLACES, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "library_ms": None, "library_note": REGION_LIBRARY_NOTE})
        run_ms = {low: cuda_ms(torch, lambda: comp(env), reps=5, inner=3,
                               warmup=2)
                  for low, comp in comps.items()}
        print(f"end-to-end region {name}: Compiled.run " + ", ".join(
            f"{low} {t:.4f} ms" for low, t in run_ms.items())
            + f"; spans sum: kernel {ms:.4f} ms, bound "
            f"{bound_s * 1e3:.4f} ms on {card}")
        for low in ("kernel", "fused"):
            profile_run(torch, lambda: comps[low](env), card, run_ms[low],
                        f"region {name} lowering={low}", ("K1", "span_"))
        del comps, outs, ref, env
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# PolyBench linear algebra: K1's products on tl.dot
# ---------------------------------------------------------------------------

PB_RANKS = 8                   # the static schedule: one chunk per rank
PB_LAUNCHES = {"2mm": 2, "3mm": 3, "atax": 3, "bicg": 2, "mvt": 2,
               "covariance": 2}            # K1 launches per run (else 1)
#: tl.dot calls per block: one per aten.mm of its body
PB_DOTS = {"gemm": (1,), "2mm": (1, 1), "3mm": (1, 1, 1), "atax": (0, 0, 0),
           "bicg": (0, 0), "mvt": (0, 0), "gesummv": (0,), "syrk": (1,),
           "syr2k": (2,), "covariance": (0, 1), "jacobi2d": (0,)}
#: row-sum K loops per block: one per aten.mv (no tl.dot)
PB_MVS = {"atax": (1, 0, 0), "bicg": (1, 0), "mvt": (1, 0), "gesummv": (2,)}
#: blocks whose product is a matrix's (aten.mm): the check must also tell
#: their plain values computed in TF32 (cuBLAS's mv takes no TF32)
PB_MM = {"gemm": (0,), "2mm": (0, 1), "3mm": (0, 1, 2), "syrk": (0,),
         "syr2k": (0,), "covariance": (1,)}
#: ``agree``'s tolerance on a matrix product's span: its absolute term
#: scales with the largest value, which syrk's diagonal (~30, a sum of
#: squares) makes 40x a row's RMS; at 1e-4 it would pass TF32's ~1.4e-3.
#: IEEE float32 summed in another order lies within ~1e-5 of it.
PB_MM_TOL = 1e-5
PB_LIBRARY_NOTE = {
    "gemm": "torch.addmm (beta 1.2, alpha 1.5)",
    "2mm": "torch.mm, then torch.addmm (tmp C + D)",
    "3mm": "torch.mm per block",
    "atax": "torch.mv, then torch.mul (A * tmp) and torch.clone (fold's rows)",
    "bicg": "torch.mv, then torch.mul (A * r)",
    "mvt": "torch.addmv, then torch.mul (A * y2)",
    "gesummv": "null: no single call computes 1.5 A x + 1.2 B x",
    "syrk": "torch.addmm (beta 1.2, alpha 1.5)",
    "syr2k": "null: no single call computes A B^T + B A^T",
    "covariance": "torch.addmm (beta 0, alpha 1/(n-1)) for the cov block "
                  "only: no single call centres the rows",
    "jacobi2d": "F.conv2d (the five-point cross of 0.25, as heat2d's "
                "row; it leaves out the edge columns the body wraps)",
}


def pb_library(name, torch, env, block):
    """One PyTorch call computing block ``block``'s values on ``env`` (a
    yardstick the port never calls), or None."""
    e = env                     # short: the calls below read many keys
    cross = torch.tensor([[0.0, 0.25, 0.0], [0.25, 0.0, 0.25],
                          [0.0, 0.25, 0.0]], device=e[next(iter(e))].device)
    calls = {
        "jacobi2d": [lambda: torch.nn.functional.conv2d(
            e["A"][None, None], cross.view(1, 1, 3, 3))],
        "gemm": [lambda: torch.addmm(e["C"], e["A"], e["B"], beta=1.2,
                                     alpha=1.5)],
        "2mm": [lambda: torch.mm(e["A"], e["B"]),
                lambda: torch.addmm(e["D"], e["tmp"], e["C"])],
        "3mm": [lambda: torch.mm(e["A"], e["B"]),
                lambda: torch.mm(e["C"], e["D"]),
                lambda: torch.mm(e["E"], e["F"])],
        "atax": [lambda: torch.mv(e["A"], e["x"]),
                 lambda: torch.mul(e["A"], e["tmp"][:, None]),
                 lambda: torch.clone(e["partial"])],
        "bicg": [lambda: torch.mv(e["A"], e["p"]),
                 lambda: torch.mul(e["A"], e["r"][:, None])],
        "mvt": [lambda: torch.addmv(e["x1"], e["A"], e["y1"]),
                lambda: torch.mul(e["A"], e["y2"][:, None])],
        "syrk": [lambda: torch.addmm(e["C"], e["A"], e["A"].T, beta=1.2,
                                     alpha=1.5)],
        "covariance": [None, lambda: torch.addmm(
            e["C"], e["centered"], e["centered"].T, beta=0.0,
            alpha=1.0 / (e["centered"].shape[1] - 1))],
    }.get(name)
    return None if calls is None else calls[block]


def rows_of(values, mask):
    """The rows ``agree_rows`` holds: one per lane that holds an
    iteration (its vector of values), or, for one value a lane (a
    trailing dim of one too: a product one column wide), the lanes of a
    chunk."""
    if values.dim() > mask.dim() and values[mask].shape[1:].numel() == 1:
        values = values.reshape(mask.shape)
    return values[mask] if values.dim() > mask.dim() else values


def tree_to(tree, dev):
    """A dict of tensors (nested) copied to ``dev``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def check_pb_span(torch, span_kernel, kernel_lower, comp, prog, env, dev,
                  label, mm, lane_dim=None,
                  host=False) -> tuple[float, float]:
    """The block's span kernel against its plain version on the same
    inputs: ``hold_lanes`` (``agree`` and its rejections, given
    ``lane_dim`` the plain values moved by one lane too) and
    ``hold_rows`` (one row per lane) at ``span_tol``; for a matrix
    product (``mm``) both checks must also reject the plain values
    computed with TF32 allowed, and ``agree`` holds it at PB_MM_TOL.
    ``host``: the plain version runs on the host's copy of the inputs
    (``HOST_PLAIN``).  Returns (max abs err, worst row-relative err)."""
    from repro_torch.core import transform

    repl, slabs = transform.stage_inputs(comp.plan, env)
    (span,) = comp.kernel_plan.spans
    (got,) = span_kernel.span_stage_values(
        one_stage(kernel_lower, comp.plan, prog, slabs, repl), span.source,
        dev)
    if host:
        want = {k: v.to(dev) for k, v in span_kernel.span_values_plain(
            comp.plan, prog, tree_to(slabs, "cpu"), tree_to(repl, "cpu"),
            torch.device("cpu")).items()}
    else:
        want = span_kernel.span_values_plain(comp.plan, prog, slabs, repl,
                                             dev)
    mask = kernel_lower.lane_mask(comp.plan, dev)
    tol = span_tol(span.source)
    err = hold_lanes(torch, got, want, mask, PB_MM_TOL if mm else tol, label,
                     lane_dim)
    hold_launch_bits(torch, kernel_lower, span_kernel, span.source,
                     one_stage(kernel_lower, comp.plan, prog, slabs, repl),
                     dev, label)
    worst = 0.0
    for k in want:
        if not want[k].is_floating_point():
            continue                    # held bit for bit by hold_lanes
        # lanes that hold no iteration take the plain value
        g = torch.where(mask.reshape(mask.shape + (1,) * (
            want[k].dim() - mask.dim())), got[k], want[k])
        worst = max(worst, hold_rows(torch, rows_of(g, mask),
                                     rows_of(want[k], mask), tol,
                                     f"{label} {k}"))
    if mm:
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = span_kernel.span_values_plain(comp.plan, prog, slabs,
                                                 repl, dev)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        for k in want:
            w, t = want[k][mask], tf32[k][mask]
            if agree(torch, t, w, PB_MM_TOL) or agree_rows(
                    torch, rows_of(tf32[k], mask), rows_of(want[k], mask),
                    tol):
                raise AssertionError(
                    f"{label} {k}: the checks at tol={PB_MM_TOL}/{tol} "
                    "cannot tell the plain values computed in TF32 (max abs "
                    "diff "
                    f"{(t - w).abs().max().item():.3e})")
    return err, worst


def pb_bound(torch, env, src, trip) -> tuple[int, int, int]:
    """(bytes, flops, flops on ``tl.dot``) of one PolyBench span: each
    env array it reads once, each output's values on the loop's
    iterations once; its flops on the loop's iterations."""
    keys = dict.fromkeys(key for _, _, key in src.inputs)
    nbytes = sum(env[key].numel() * env[key].element_size() for key in keys)
    nbytes += sum(trip * math.prod(shape[3:])
                  * torch.empty((), dtype=dt).element_size()
                  for _, _, shape, dt in src.outputs)
    return nbytes, src.flops_per_lane * trip, src.dot_flops_per_lane * trip


def pb_ops_s(flops, dot_flops, tf32x3) -> float:
    """The least time for a span's operations at the accuracy its
    precision keeps: its ``tl.dot`` flops three times over (3xTF32) at
    the TF32 tensor-core rate, or all its flops at the float32 rate."""
    if tf32x3:
        return ((flops - dot_flops) / FP32_FLOPS_PER_S
                + 3 * dot_flops / TF32_FLOPS_PER_S)
    return flops / FP32_FLOPS_PER_S


def polybench_phase(torch, dev, card, names=None):
    """Phase 17: the PolyBench kernels of ``repro_torch.polybench``
    (``names``, or the linear-algebra kernels and the stencils) at
    EXTRALARGE size through both block lowerings against
    ``run_reference``, K1's launches per run, each span against its plain
    version and twice against itself, and times per block.  Returns the
    kernel-table rows."""
    from repro_torch import omp
    from repro_torch import polybench as pb
    from repro_torch.core import kernel_lower, transform
    from repro_torch.kernels import span_kernel

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("run_reference and the plain versions must "
                             "run without TF32")
    print("polybench: torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32} (run_reference, the "
          "collective lowering and the plain versions in IEEE float32)")
    mesh = omp.make_mesh((PB_RANKS,), ("data",), device=dev)
    rows = []
    for name in names or pb.LINEAR_ALGEBRA + pb.STENCILS:
        t0 = time.perf_counter()
        kernel = pb.make(name)
        env = kernel.env_fn(dev, seed=0)
        torch.cuda.synchronize()
        t_env = time.perf_counter() - t0
        progs = kernel.programs
        ref = run_blocks(progs, env)
        coll = run_blocks([omp.compile(p, mesh, lowering="collective",
                                       schedule=omp.static()) for p in progs],
                          env)
        comps = [omp.compile(p, mesh, lowering="kernel", schedule=omp.static(),
                             env_like=env) for p in progs]
        run_blocks(comps, env)          # first run: Triton builds K1
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0 - t_env
        span_kernel.LAUNCHES = 0
        kern = run_blocks(comps, env)
        torch.cuda.synchronize()
        launches = span_kernel.LAUNCHES
        planned = sum(c.kernel_plan.n_kernels for c in comps)
        if launches != PB_LAUNCHES.get(name, 1) or launches != planned:
            raise AssertionError(f"polybench {name}: K1 launched {launches} "
                                 f"times, planned {planned}, want "
                                 f"{PB_LAUNCHES.get(name, 1)}")
        for label, got in (("collective", coll), ("kernel", kern)):
            for k in ref:
                torch.testing.assert_close(
                    got[k], ref[k], rtol=1e-4, atol=1e-4,
                    msg=lambda m: f"polybench {name}/{label} {k}: {m}")
                if not bool(torch.isfinite(got[k]).all()):
                    raise AssertionError(f"polybench {name}/{label} {k}: "
                                         "not finite")
        mvs = PB_MVS.get(name, (0,) * len(progs))
        precisions = []
        for c, dots, mv in zip(comps, PB_DOTS[name], mvs):
            text = c.kernel_plan.spans[0].source.text
            stated = re.findall(r'input_precision="(\w+)"', text)
            if text.count("tl.dot(") != dots or len(stated) != dots or (
                    text.count("tl.range(") != mv) or not set(stated) <= {
                    "tf32x3", "ieee"}:
                raise AssertionError(
                    f"polybench {name}/{c.plan.name}: "
                    f"{text.count('tl.dot(')} tl.dot ({stated}) and "
                    f"{text.count('tl.range(')} row-sum loops, want {dots} "
                    f"float32 tl.dot each stating its precision and {mv}")
            precisions += stated
        print(f"polybench {name} {kernel.dims}: {len(progs)} block(s) on "
              f"{PB_RANKS} ranks (static), collective and kernel == "
              f"run_reference (rtol=atol=1e-4); K1 launches per run "
              f"{launches} (planned {planned}); tl.dot per block "
              f"{list(PB_DOTS[name])} at {sorted(set(precisions))}, "
              f"row-sum loops per block {list(mvs)}; spans "
              + "; ".join(c.kernel_plan.spans[0].describe() for c in comps)
              + f"; env {t_env:.2f} s, compile+build {t_build:.2f} s")

        # kernel vs plain, twice against itself, then times, block by
        # block on the env it sees
        err = worst = 0.0
        ms = plain_ms = bound_s = dev_ms = host_ms = 0.0
        ms_old = host_old = 0.0
        lib_ms = lib_dev_ms = 0.0
        lib_any = False
        nbytes = ops_s = 0
        benv = env
        for b, (prog, comp) in enumerate(zip(progs, comps)):
            label = f"polybench {name}/{prog.name}"
            e, w = check_pb_span(torch, span_kernel, kernel_lower, comp,
                                 prog, benv, dev, label,
                                 b in PB_MM.get(name, ()),
                                 2 if name in pb.STENCILS else None)
            err, worst = max(err, e), max(worst, w)
            repl, slabs = transform.stage_inputs(comp.plan, benv)
            src = comp.kernel_plan.spans[0].source
            one = one_stage(kernel_lower, comp.plan, prog, slabs, repl)
            # on the lanes that hold an iteration (the kernel writes no
            # other)
            mask = kernel_lower.lane_mask(comp.plan, dev)
            first, again = (span_kernel.span_stage_values(one, src, dev)[0]
                            for _ in range(2))
            if not all(torch.equal(first[k][mask], again[k][mask])
                       for k in first):
                raise AssertionError(f"{label}: two launches on the same "
                                     "input differ")
            print(f"bits {label}: two launches on the same input equal bit "
                  f"for bit ({', '.join(sorted(first))})")
            io = [(slabs, repl)]
            turns = launch_turns(torch, {
                "launcher": lambda: span_kernel.span_stage_values(
                    one, src, dev),
                "triton": lambda: span_kernel.launch_span_triton(
                    src, io, dev)})
            b_ms, b_dev, b_host = turns["launcher"]
            b_ms_old, b_dev_old, b_host_old = turns["triton"]
            print(f"launch {label}: host enqueue {b_host:.4f} ms (K1's "
                  f"launcher) vs {b_host_old:.4f} ms (Triton's launch path); "
                  f"back to back {b_ms:.4f} vs {b_ms_old:.4f} ms; device "
                  f"{b_dev:.4f} vs {b_dev_old:.4f} ms on {card}")
            b_plain = cuda_ms(torch, lambda: span_kernel.span_values_plain(
                comp.plan, prog, slabs, repl, dev), reps=5, inner=5)
            bb, ff, df = pb_bound(torch, benv, src, comp.plan.nest.total_trip)
            tf32x3 = 'input_precision="tf32x3"' in src.text
            b_ops = pb_ops_s(ff, df, tf32x3)
            b_bound = max(bb / HBM_BYTES_PER_S, b_ops)
            lib = pb_library(name, torch, benv, b)
            b_lib = cuda_ms(torch, lib) if lib is not None else None
            b_lib_dev = device_ms(torch, lib)[0] if lib is not None else None
            print(f"block {label}: kernel {b_ms:.4f} ms (device "
                  f"{b_dev:.4f} ms a call, {b_bound * 1e3 / b_dev:.0%} of "
                  f"the bound; the host enqueues one in {b_host:.4f} ms), "
                  f"plain {b_plain:.4f} ms, library "
                  + ("null" if b_lib is None else
                     f"{b_lib:.4f} ms (device {b_lib_dev:.4f} ms)")
                  + f", bound {b_bound * 1e3:.4f} ms ("
                  + ("bytes" if bb / HBM_BYTES_PER_S >= b_ops
                     else "operations")
                  + f": {bb} B at {HBM_BYTES_PER_S:.3g} B/s; {ff} flops, "
                  f"{df} on tl.dot: {pb_ops_s(ff, df, True) * 1e3:.4f} ms "
                  f"at 3xTF32 ({TF32_FLOPS_PER_S:.3g} flop/s x 3), "
                  f"{pb_ops_s(ff, df, False) * 1e3:.4f} ms in IEEE float32 "
                  f"({FP32_FLOPS_PER_S:.3g} flop/s); the span runs "
                  + ("3xTF32" if tf32x3 else "no TF32") + f") on {card}")
            ms, plain_ms, bound_s = ms + b_ms, plain_ms + b_plain, \
                bound_s + b_bound
            dev_ms, host_ms = dev_ms + b_dev, host_ms + b_host
            ms_old, host_old = ms_old + b_ms_old, host_old + b_host_old
            nbytes, ops_s = nbytes + bb, ops_s + b_ops
            if b_lib is not None:
                lib_ms, lib_dev_ms = lib_ms + b_lib, lib_dev_ms + b_lib_dev
                lib_any = True
            benv = comp(benv)
        bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S >= ops_s
                    else "operations")
        library_ms = lib_ms if lib_any else None
        print(f"kernel-vs-plain polybench {name}: max_abs_err={err:.3e}, "
              f"worst row-relative err {worst:.3e}"
              + (f" (agree at {PB_MM_TOL} on the mm spans), TF32 plain "
                 "values rejected" if name in PB_MM else ""))
        lib_s = "null" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"times polybench {name}: kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f} ms, host enqueue {host_ms:.4f} ms; Triton's "
              f"launch path {ms_old:.4f} ms, enqueue {host_old:.4f} ms), "
              "plain "
              f"{plain_ms:.4f} ms, library {lib_s} "
              + (f"(device {lib_dev_ms:.4f} ms) " if lib_any else "")
              + f"({PB_LIBRARY_NOTE[name]}), bound {bound_s * 1e3:.4f} ms "
              f"(the sum of its blocks' bounds; {bound_by}: {nbytes} B at "
              f"{HBM_BYTES_PER_S:.3g} B/s, operations "
              f"{ops_s * 1e3:.4f} ms) on {card}")
        run_ms = {low: cuda_ms(torch, lambda: run_blocks(bs, env), reps=3,
                               inner=2, warmup=1)
                  for low, bs in (("kernel", comps), ("collective", [
                      omp.compile(p, mesh, lowering="collective",
                                  schedule=omp.static()) for p in progs]))}
        print(f"end-to-end polybench {name}: Compiled.run kernel "
              f"{run_ms['kernel']:.4f} ms, collective "
              f"{run_ms['collective']:.4f} ms on {card}")
        rows.append({
            "name": f"span_kernel[polybench {name}]", "route": "triton",
            "source": SOURCE, "replaces": REPLACES, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "library_ms": library_ms, "device_ms": dev_ms, "host_ms": host_ms,
            "ms_triton_launch": ms_old, "host_ms_triton_launch": host_old,
            "library_device_ms": lib_dev_ms if lib_any else None,
            "library_note": PB_LIBRARY_NOTE[name]})
        del comps, ref, coll, kern, env, benv
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Repairs: programs the reference runs that K1 and K2 once refused
# ---------------------------------------------------------------------------

REPAIR_ROWS = 2000             # lanes of the rank-1 cumsum block
REPAIR_WIDTH = 2600            # its rows (PolyBench EXTRALARGE: 2000-4000)
REPAIR2 = (200, 200, 512)      # the rank-2 cumsum block: i, j, row
REPAIR_FWD = (16384, 1000)     # the forwarded-roll region: lanes, row
REPAIR_GATHER = 4              # per-lane index vector of the gather (N1 lanes)
REPAIR_SORT = (16384, 512)     # the sort: lanes, row (one register tile)
REPAIR_HANDOFF = (8192, 4096)  # the tile-by-tile hand-off: lanes, row
REPAIR_ARGSORT = (16384, 512)  # the sort's indices: lanes, row (one tile)
REPAIR_POW = 5                 # the constant exponent of the int32 pow
REPAIR_ONE_COL = 8             # columns of the matrix whose one is taken
REPAIR_INT_N = 64              # columns of the int32 product's matrix
#: programs whose plain version runs on the host: torch has no CUDA
#: integer matrix product ("addmm_cuda" / "mv" not implemented for 'Int')
HOST_PLAIN = {"int_mm"}
K2_WIDE_HD = (288, 512)        # head dims over 256 (the wide kernel)


def repair_programs(omp, torch, dev):
    """Phase 18's programs, ``name -> (program, env, mesh shape, axes,
    library call or None, note)``: (a) ``cumsum`` along a per-lane row on
    rank 1 (a loaded row and a computed one; consumed whole, rolled, by
    a product with a 2600 x 2600 matrix, reduced and at one position),
    a rolled scan in a span with no product (its row swept tile by tile,
    both segments carried) and rank 2; (b) ``roll`` of a lane scalar (the identity) on rank 1 (N =
    2^24) and rank 2 (4096 x 4096); (c) a region whose later stages roll
    a row the first stage forwards in a register tile.  Seeded normal
    data."""
    g = torch.Generator(device=dev).manual_seed(18)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    n, w = REPAIR_ROWS, REPAIR_WIDTH

    @omp.parallel_for(start=1, stop=n, reduction={"s": "+"},
                      name="cumsum1")
    def cumsum1(i, env):
        row = env["A"][i]
        c = torch.cumsum(row, 0)
        d = torch.cumsum(2.0 * row - env["w"], 0)
        return {"Y": omp.at(i, c - torch.roll(d, 2)),
                "P": omp.at(i, c @ env["M"]),
                "s": omp.red(c[3] + d.sum())}

    @omp.parallel_for(stop=n, reduction={"s": "+"}, name="roll_scan")
    def roll_scan(i, env):
        row = env["A"][i]
        c = torch.cumsum(row, 0)
        return {"Y": omp.at(i, torch.roll(c, 3)
                            - torch.roll(torch.cumsum(row * env["w"], 0),
                                         -1)),
                "s": omp.red(torch.roll(c, 2)[0])}

    ni, nj, k = REPAIR2

    @omp.parallel_for(stop=(ni, nj), collapse=2, name="cumsum2")
    def cumsum2(i, j, env):
        v = torch.cumsum(env["A"][i] * env["B"][j], 0)
        return {"Z": omp.at((i, j), v + torch.cumsum(env["A"][j], 0)),
                "T": omp.at((i, j), (v * env["w"]).sum())}

    @omp.parallel_for(stop=N1, name="lane_roll1")
    def lane_roll1(i, env):
        return {"y": omp.at(i, torch.roll(env["x"][i], 1) * 2.0)}

    @omp.parallel_for(stop=(N2, N2), collapse=2, name="lane_roll2")
    def lane_roll2(i, j, env):
        return {"z": omp.at((i, j), torch.roll(env["X"][i, j], 1)
                            + env["X"][i, j])}

    lanes, width = REPAIR_FWD

    @omp.parallel_for(stop=lanes, name="w1")
    def w1(i, env):
        return {"V": omp.at(i, env["X"][i] * 2.0)}

    @omp.parallel_for(stop=lanes, name="w2")
    def w2(i, env):
        return {"y": omp.at(i, torch.roll(env["V"][i], 1).sum())}

    @omp.parallel_for(stop=lanes, name="w3")
    def w3(i, env):
        return {"Z": omp.at(i, torch.roll(env["V"][i], 2)
                            - env["V"][i] * env["w"])}

    @omp.parallel_for(stop=N1, name="math1")
    def math1(i, env):
        x = env["x"][i]
        a = (torch.sin(x) + torch.cos(x) * torch.tan(0.25 * x)
             + torch.tanh(x) + torch.sigmoid(x)
             + torch.rsqrt(torch.abs(x) + 1.0) + torch.erf(x))
        b = (torch.pow(x, 3.0) + x ** 2 + torch.pow(torch.abs(x) + 0.5, x)
             + torch.pow(2.0, x) + torch.floor(3.0 * x) + torch.ceil(3.0 * x)
             + torch.round(2.0 * x) + torch.sign(x))
        c = (torch.clamp(x, -0.5, 0.5) + torch.clamp_min(x, 0.1)
             + torch.clamp_max(x, 0.2) + torch.log1p(torch.abs(x))
             + torch.expm1(0.5 * x))
        return {"y": omp.at(i, a + b * c)}

    @omp.parallel_for(stop=n, reduction={"s": "+"}, name="cumprod1")
    def cumprod1(i, env):
        row = env["A"][i]
        c = torch.cumprod(row, 0)
        return {"Y": omp.at(i, c - torch.roll(torch.cumprod(
                    row * env["w"], 0), 2)),
                "s": omp.red(c[3] + torch.roll(c, -1)[0] + c.sum())}

    @omp.parallel_for(stop=N1, name="gather1")
    def gather1(i, env):
        g = env["x"][env["I"][i]]
        return {"Y": omp.at(i, g * 2.0 + env["x"][env["I"][i] - 3])}

    sort_lanes, sort_w = REPAIR_SORT

    @omp.parallel_for(stop=sort_lanes, name="sort1")
    def sort1(i, env):
        return {"Z": omp.at(i, torch.sort(env["A"][i]).values)}

    h_lanes, h_w = REPAIR_HANDOFF

    # static: chunks of 1024 lanes, so that a row of 4096 does not fit one
    # register tile of the span's lanes and is stored tile by tile
    @omp.parallel_for(stop=h_lanes, schedule=omp.static(), name="h1")
    def h1(i, env):
        return {"V": omp.at(i, env["X"][i] * 2.0 + env["w"])}

    @omp.parallel_for(stop=h_lanes, schedule=omp.static(), name="h2")
    def h2(i, env):
        v = env["V"][i]
        return {"y": omp.at(i, v.sum() + v[3]), "Z": omp.at(i, v * env["w"])}

    def scan_row(name, fn):
        @omp.parallel_for(stop=n, name=name)
        def scan1(i, env):
            return {"Y": omp.at(i, fn(env["A"][i]))}
        return scan1

    lse1 = scan_row("logcumsumexp1", lambda r: torch.logcumsumexp(r, 0))
    cummax1 = scan_row("cummax1", lambda r: torch.cummax(r, 0).values)
    cummin1 = scan_row("cummin1", lambda r: torch.cummin(r, 0).values)
    as_lanes, as_w = REPAIR_ARGSORT

    @omp.parallel_for(stop=as_lanes, name="argsort1")
    def argsort1(i, env):
        return {"Z": omp.at(i, torch.argsort(env["A"][i]))}

    @omp.parallel_for(stop=N1, name="int_pow1")
    def int_pow1(i, env):
        return {"y": omp.at(i, env["x"][i] ** REPAIR_POW)}

    @omp.parallel_for(stop=n, name="one_col1")
    def one_col1(i, env):
        return {"Y": omp.at(i, env["A"][i] @ env["M"][:, 2:3])}

    @omp.parallel_for(stop=n, name="int_mm1")
    def int_mm1(i, env):
        return {"Q": omp.at(i, env["K"][i] @ env["L"])}

    x1, x2 = rnd(N1), rnd(N2, N2)
    near1 = 1.0 + 0.01 * rnd(n, w)
    scan_a = rnd(n, w)
    # few distinct values: ties everywhere, which a stable order keeps
    tied = torch.randint(-8, 8, (as_lanes, as_w), generator=g, device=dev,
                         dtype=torch.int32).float()
    # |x|^5 passes 2^31: the products wrap, as int32's do
    ints = torch.randint(-2000, 2000, (N1,), generator=g, device=dev,
                         dtype=torch.int32)
    # indices in range, negative (wrapping once) and out of range
    idx = torch.randint(-N1 - 64, N1 + 64, (N1, REPAIR_GATHER), generator=g,
                        device=dev, dtype=torch.int32)
    sort_a = rnd(sort_lanes, sort_w)
    one_a, one_m = rnd(n, w), rnd(w, REPAIR_ONE_COL)
    # |K L| passes 2^31: the products and their sums wrap in int32
    int_k, int_l = (torch.randint(-60000, 60000, shape, generator=g,
                                  device=dev, dtype=torch.int32)
                    for shape in ((n, w), (w, REPAIR_INT_N)))
    return {
        "cumsum1": (cumsum1, {"A": rnd(n, w), "w": rnd(w), "M": rnd(w, w),
                              "Y": zeros(n, w), "P": zeros(n, w),
                              "s": zeros()},
                    (PB_RANKS,), ("data",), None,
                    "null: no single call computes cumsum, roll and mm"),
        "roll_scan": (roll_scan, {"A": rnd(n, w), "w": rnd(w),
                                  "Y": zeros(n, w), "s": zeros()},
                      (PB_RANKS,), ("data",), None,
                      "null: no single call computes a rolled scan"),
        "cumsum2": (cumsum2, {"A": rnd(nj, k), "B": rnd(nj, k), "w": rnd(k),
                              "Z": zeros(ni, nj, k), "T": zeros(ni, nj)},
                    (4, 2), ("i", "j"), None,
                    "null: no single call computes two scans of rows"),
        "lane_roll1": (lane_roll1, {"x": x1, "y": zeros(N1)}, (PB_RANKS,),
                       ("data",), lambda: torch.mul(x1, 2.0),
                       "torch.mul (y = 2 x)"),
        "lane_roll2": (lane_roll2, {"X": x2, "z": zeros(N2, N2)}, (4, 2),
                       ("i", "j"), lambda: torch.add(x2, x2),
                       "torch.add (z = X + X)"),
        "math": (math1, {"x": x1, "y": zeros(N1)}, (PB_RANKS,), ("data",),
                 None, "null: no single call computes the composite body"),
        "cumprod": (cumprod1, {"A": near1, "w": 1.0 + 0.01 * rnd(w),
                               "Y": zeros(n, w), "s": zeros()},
                    (PB_RANKS,), ("data",), None,
                    "null: no single call computes cumprod, roll and sums"),
        "gather": (gather1, {"x": x1, "I": idx,
                             "Y": zeros(N1, REPAIR_GATHER)},
                   (PB_RANKS,), ("data",), None,
                   "null: torch.take raises on the out-of-range indices the "
                   "body clamps"),
        "sort": (sort1, {"A": sort_a, "Z": zeros(sort_lanes, sort_w)},
                 (PB_RANKS,), ("data",),
                 lambda: torch.sort(sort_a, dim=1).values,
                 "torch.sort (values, along the rows)"),
        "logcumsumexp": (lse1, {"A": scan_a, "Y": zeros(n, w)},
                         (PB_RANKS,), ("data",),
                         lambda: torch.logcumsumexp(scan_a, 1),
                         "torch.logcumsumexp (along the rows)"),
        "cummax": (cummax1, {"A": scan_a, "Y": zeros(n, w)}, (PB_RANKS,),
                   ("data",), lambda: torch.cummax(scan_a, 1),
                   "torch.cummax (values and indices, along the rows)"),
        "cummin": (cummin1, {"A": scan_a, "Y": zeros(n, w)}, (PB_RANKS,),
                   ("data",), lambda: torch.cummin(scan_a, 1),
                   "torch.cummin (values and indices, along the rows)"),
        "argsort": (argsort1, {"A": tied, "Z": torch.zeros(
                        as_lanes, as_w, dtype=torch.int64, device=dev)},
                    (PB_RANKS,), ("data",),
                    lambda: torch.argsort(tied, dim=1, stable=True),
                    "torch.argsort(stable=True) (along the rows)"),
        "int_pow": (int_pow1, {"x": ints, "y": torch.zeros_like(ints)},
                    (PB_RANKS,), ("data",),
                    lambda: torch.pow(ints, REPAIR_POW),
                    f"torch.pow (x ** {REPAIR_POW}, int32)"),
        "one_column": (one_col1, {"A": one_a, "M": one_m,
                                  "Y": zeros(n, 1)}, (PB_RANKS,),
                       ("data",), lambda: torch.mm(one_a, one_m[:, 2:3]),
                       "torch.mm (rows times one column)"),
        "int_mm": (int_mm1, {"K": int_k, "L": int_l, "Q": torch.zeros(
                       n, REPAIR_INT_N, dtype=torch.int32, device=dev)},
                   (PB_RANKS,), ("data",), None,
                   "null: torch has no CUDA int32 matrix product (addmm_cuda "
                   "not implemented for 'Int'); the plain version runs on "
                   "the host"),
        "handoff": (omp.region(h1, h2, name="handoff"),
                    {"X": rnd(h_lanes, h_w), "w": rnd(h_w),
                     "V": zeros(h_lanes, h_w), "y": zeros(h_lanes),
                     "Z": zeros(h_lanes, h_w)}, (PB_RANKS,), ("data",), None,
                    REGION_LIBRARY_NOTE),
        "roll_fwd": (omp.region(w1, w2, w3, name="roll_fwd"),
                     {"X": rnd(lanes, width), "V": zeros(lanes, width),
                      "y": zeros(lanes), "Z": zeros(lanes, width),
                      "w": rnd(width)}, (PB_RANKS,), ("data",), None,
                     REGION_LIBRARY_NOTE),
    }


def span_shared(span_kernel, spans) -> list:
    """Bytes of shared memory of each compiled kernel K1's launcher holds
    for these spans (none where the spans ran no kernel)."""
    got = []
    for sp in spans:
        launcher = span_kernel._LAUNCHERS.get(
            span_kernel.launcher_key(sp.source))
        if launcher is not None:
            got += sorted({e.shared for e in launcher.kernels.values()})
    return got


def repair_phase(torch, dev, card):
    """Phase 18: the repaired programs (``repair_programs``) under
    ``lowering="kernel"`` against their shared-memory run (``agree`` at
    1e-4), K1's launches per run, every span against its plain
    version (``agree``/``agree_rows`` and their rejections; the region's
    on seeded normal data with the one-lane move rejected) and against
    Triton's launch path bit for bit, and times.  Returns the
    kernel-table rows."""
    from repro_torch import omp
    from repro_torch.core import kernel_lower, transform
    from repro_torch.kernels import span_kernel

    rows = []
    for name, (prog, env, shape, axes, lib, note) in repair_programs(
            omp, torch, dev).items():
        t0 = time.perf_counter()
        mesh = omp.make_mesh(shape, axes, device=dev)
        host = name in HOST_PLAIN
        ref = ({k: v.to(dev) for k, v in prog(tree_to(env, "cpu")).items()}
               if host else prog(env))
        comp = omp.compile(prog, mesh, lowering="kernel", env_like=env)
        comp(env)                       # first run: Triton builds K1
        torch.cuda.synchronize()
        span_kernel.LAUNCHES = 0
        out = comp(env)
        torch.cuda.synchronize()
        launches = span_kernel.LAUNCHES
        planned = comp.kernel_plan.n_kernels
        if launches != planned or planned == 0:
            raise AssertionError(f"repair {name}: K1 launched {launches} "
                                 f"times, planned {planned}")
        # agree at 1e-4: atol scales with the largest value, since a scan
        # of 2600 normal values reaches ~100, where two float32 sums in
        # another order differ by more than a fixed 1e-4
        for k in ref:
            if not ref[k].is_floating_point():
                if not torch.equal(out[k], ref[k]):
                    raise AssertionError(f"repair {name} {k}: kernel != "
                                         "prog(env) (integers, bit for bit)")
                continue
            if not agree(torch, out[k], ref[k], 1e-4):
                raise AssertionError(
                    f"repair {name} {k}: kernel != prog(env), max abs err "
                    f"{(out[k] - ref[k]).abs().max().item():.3e} (max "
                    f"|value| {ref[k].abs().max().item():.3e})")
            if not bool(torch.isfinite(out[k]).all()):
                raise AssertionError(f"repair {name} {k}: not finite")
        texts = [sp.source.text for sp in comp.kernel_plan.spans]
        region = hasattr(prog, "stages")
        if region:
            calls, err = check_region_spans(torch, kernel_lower, span_kernel,
                                            comp, env, dev, f"repair {name}")
            fwd = [list(src.forwarded) for _, src in calls]
            readers = (1, 2) if name == "roll_fwd" else (1,)
            if not any(all((r, "V") in f for r in readers) for f in fwd):
                raise AssertionError(f"repair {name}: V not forwarded to "
                                     f"stages {readers}: {fwd}")
            if name == "handoff" and not all(
                    "tl.debug_barrier()" in t for t in texts):
                raise AssertionError("repair handoff: V is not re-loaded "
                                     "after a barrier (held whole?)")
        else:
            err, worst = check_pb_span(torch, span_kernel, kernel_lower,
                                       comp, prog, env, dev,
                                       f"repair {name}", False, host=host)
            repl, slabs = transform.stage_inputs(comp.plan, env)
            calls = [(one_stage(kernel_lower, comp.plan, prog, slabs, repl),
                      comp.kernel_plan.spans[0].source)]
            if host:
                host_stages = one_stage(kernel_lower, comp.plan, prog,
                                        tree_to(slabs, "cpu"), tree_to(repl, "cpu"))
        worst_s = "n/a (region: per stage above)" if region else f"{worst:.3e}"
        print(f"repair {name}: {prog.name} on a "
              f"{'x'.join(map(str, shape))} mesh: kernel == prog(env) "
              f"(agree at 1e-4), K1 launches per run {launches} (planned "
              f"{planned}); spans vs plain max_abs_err={err:.3e}, worst "
              f"row-relative err {worst_s}, K1's launcher == Triton's "
              f"launch path bit for bit; tl.cumsum "
              f"{sum(t.count('tl.cumsum(') for t in texts)}, tl.cumprod "
              f"{sum(t.count('tl.cumprod(') for t in texts)}, "
              f"tl.associative_scan "
              f"{sum(t.count('tl.associative_scan(') for t in texts)}, tl.sort "
              f"{sum(t.count('tl.sort(') for t in texts)}, libdevice calls "
              f"{sum(t.count('libdevice.') - 1 for t in texts if 'libdevice' in t)}"
              f", barriers {sum(t.count('tl.debug_barrier()') for t in texts)}"
              f", rolled reads "
              f"{sum(t.count(') % ') for t in texts)}, tl.dot "
              f"{sum(t.count('tl.dot(') for t in texts)}, row-sum products "
              f"{sum(t.count('[:, :, None] *') for t in texts)}; shared memory "
              f"{span_shared(span_kernel, comp.kernel_plan.spans)} B at "
              f"{[sp.source.num_stages for sp in comp.kernel_plan.spans]} "
              f"stages; {time.perf_counter() - t0:.2f} s")
        ms = plain_ms = bound_s = 0.0
        nbytes = flops = 0
        for stages, source in calls:
            ms += cuda_ms(torch, lambda: span_kernel.span_stage_values(
                stages, source, dev))
            if host:                    # host time: no CUDA int mm
                plain_ms += host_ms(lambda: span_kernel.
                                    span_values_plain_stages(
                                        host_stages, torch.device("cpu")))
            else:
                plain_ms += cuda_ms(torch, lambda: span_kernel.
                                    span_values_plain_stages(stages, dev),
                                    reps=3, inner=2, warmup=1)
            b, f = span_bound(torch, stages, source)
            nbytes, flops = nbytes + b, flops + f
            bound_s += max(b / HBM_BYTES_PER_S, f / FP32_FLOPS_PER_S)
        library_ms = cuda_ms(torch, lib) if lib is not None else None
        bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                    >= flops / FP32_FLOPS_PER_S else "operations")
        print(f"times repair {name}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms{' (on the host)' if host else ''}, library "
              + ("null" if library_ms is None else f"{library_ms:.4f} ms")
              + f" ({note}), bound {bound_s * 1e3:.4f} ms ({bound_by}: "
              f"{nbytes} B, {flops} flops) on {card}")
        rows.append({
            "name": f"span_kernel[repair {name}]", "route": "triton",
            "source": SOURCE, "replaces": REPLACES, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "library_ms": library_ms, "library_note": note,
            **({"plain_on": "host"} if host else {})})
        del comp, out, ref, env, calls
        torch.cuda.empty_cache()
    return rows


def k2_wide_phase(torch, dev, card):
    """Phase 18, K2 at a head_dim over 256 (the wide kernel): at B=1,
    H=4, KV=1, S=4096, causal, in bfloat16 and float32, the kernel held
    against its plain version (``hold``/``hold_rows`` at phase 6's tols;
    its launches counted around that call), then timed beside the plain
    version, SDPA and the bound.  Returns the kernel-table rows."""
    from repro_torch.kernels import flash_attention as fa

    rows = []
    tols = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
    b, h, kv, sq, sk = 1, 4, 1, PREFILL_LEN, PREFILL_LEN
    for hd in K2_WIDE_HD:
        for dtype in (torch.bfloat16, torch.float32):
            tname = dtname(dtype)
            q, k, v = k2_inputs(torch, dev, b, h, kv, sq, sk, hd, dtype, hd)
            before = sum(fa.LAUNCHES.values())
            err, row_err = check_k2(torch, fa, q, k, v, True, None,
                                    tols[dtype], f"hd{hd} S={sq} {tname}")
            launches = sum(fa.LAUNCHES.values()) - before
            if launches != 1:
                raise AssertionError(f"K2 hd{hd}: {launches} launches")
            ms = cuda_ms(torch, lambda: fa.flash_attention(
                q, k, v, causal=True), reps=5, inner=5)
            plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, causal=True), reps=3, inner=2, warmup=1)
            library_ms = cuda_ms(torch, sdpa_call(torch, q, k, v, None),
                                 reps=5, inner=5)
            bound_s, bound_by, flops, nbytes, _ = k2_bound(
                torch, b, h, kv, sq, sk, hd, None, dtype)
            rows.append({
                "name": f"flash_attention[hd{hd} S={sq} {tname}]",
                "route": "cuda", "source": K2_SOURCE,
                "replaces": K2_REPLACES, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_s * 1e3, "bound_by": bound_by,
                "library_ms": library_ms})
            print(f"K2 hd{hd} {tname} B={b} H={h} KV={kv} S={sq} causal "
                  f"(the wide kernel): kernel == plain (max_abs_err "
                  f"{err:.3e}, worst row-relative {row_err:.3e}, tol "
                  f"{tols[dtype]}); kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound "
                  f"{bound_s * 1e3:.4f} ms ({bound_by}: {flops} flops, "
                  f"{nbytes} B) on {card}")
            del q, k, v
            torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Master/worker (paper Fig. 1b) and the runtime around a compiled program
# ---------------------------------------------------------------------------

MW_RANKS = 8                   # virtual ranks of phases 19 and 20
MW_LOST = 3                    # the rank phase 20's fault plan loses


def mw_messages(plan, p_total) -> tuple[int, int]:
    """``(ppermute launches, bytes)`` the master/worker executor sends for
    one block: the reference's ``_execute_master_worker`` send by send
    (``tests/test_torch_master_worker.py`` holds this count against the
    reference's traced executor)."""
    ch = plan.chunks
    w = ch.num_devices
    first = p_total - w
    bcast = p_total - max(first, 1)         # master -> every worker
    gathers = w - (first == 0)              # workers -> master, not 0 -> 0
    launches = nbytes = 0

    def size(shape, dtype):
        import torch

        return math.prod(shape) * torch.empty((), dtype=dtype).element_size()

    for key in plan.context.env_keys:
        info = plan.context.vars[key]
        if plan.vars[key].in_strategy == "replicate":
            launches += bcast
            nbytes += bcast * size(info.shape, info.dtype)
    for key, dec in plan.vars.items():
        info = plan.context.vars[key]
        w_shape, w_dt = info.write.value_shape, info.write.value_dtype
        if dec.out_strategy in ("identity", "partial"):
            launches += gathers + bcast
            nbytes += gathers * size((ch.local_chunks, ch.chunk,
                                      *w_shape), w_dt)
            nbytes += bcast * size((ch.padded_trip, *info.shape[1:]),
                                   info.dtype)
        elif dec.out_strategy == "put":
            owner = ((plan.loop.trip_count - 1) // ch.chunk) % w + first
            sends = (owner != 0) + bcast
            launches += sends
            nbytes += sends * size(info.shape, info.dtype)
        elif dec.out_strategy == "reduce":
            launches += gathers + bcast
            nbytes += (gathers + bcast) * size(w_shape, w_dt)
    return launches, nbytes


def mw_programs(omp, torch, dev):
    """Phase 19's programs, ``name -> (blocks, env, mm)``: the PolyBench
    kernels of ``repro_torch.polybench`` at EXTRALARGE size, ``pi`` and
    ``jacobi1d`` at N = 2^24 (their sliced inputs replicated: the master
    sends whole buffers, paper Fig. 1b).  ``mm``: a body multiplies
    matrices."""
    from repro_torch import polybench as pb

    out = {}
    for name, (blocks, env, _, _) in (
            ("pi", pi_program(omp, torch, dev)),
            ("jacobi1d", jacobi1d_program(omp, torch, dev))):
        out[name] = ([p for p, _ in blocks], env, False)
    for name in pb.LINEAR_ALGEBRA + pb.STENCILS:
        kernel = pb.make(name)
        out[name] = (kernel.programs, kernel.env_fn(dev, seed=0),
                     name in PB_MM)
    return out


def hold_outputs(torch, got, ref, mm, label) -> float:
    """Every output against ``run_reference``: rtol=atol=1e-4, and
    ``agree`` at PB_MM_TOL where a body multiplies matrices; finite.
    Returns the max abs error."""
    err = 0.0
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f"{label} {k}: {m}")
        if mm and not agree(torch, got[k], ref[k], PB_MM_TOL):
            raise AssertionError(f"{label} {k}: outside PB_MM_TOL")
        if not bool(torch.isfinite(got[k]).all()):
            raise AssertionError(f"{label} {k}: not finite")
        err = max(err, (got[k] - ref[k]).abs().max().item())
    return err


def master_worker_phase(torch, dev, card):
    """Phase 19: every program of ``mw_programs`` on MW_RANKS virtual
    ranks under ``lowering="master_worker"`` with the master excluded and
    included, and as a region (staged per loop), against
    ``run_reference``; the mesh's ppermute launches and bytes against
    ``mw_messages``; ``Compiled.run`` timed under master/worker,
    collective and kernel (the static schedule each)."""
    from repro_torch import omp
    from repro_torch.kernels import span_kernel

    mesh = omp.make_mesh((MW_RANKS,), ("data",), device=dev)
    for name, (progs, env, mm) in mw_programs(omp, torch, dev).items():
        t0 = time.perf_counter()
        ref = run_blocks(progs, env)
        counts = []
        for excluded in (True, False):
            comps = [omp.compile(p, mesh, lowering="master_worker",
                                 paper_master_excluded=excluded)
                     for p in progs]
            mesh.reset_counters()
            span_kernel.LAUNCHES = 0
            got = run_blocks(comps, env)
            torch.cuda.synchronize()
            sent = (mesh.launches["ppermute"], mesh.bytes["ppermute"])
            want = [0, 0]
            for c in comps:
                for i, v in enumerate(mw_messages(c.plan, MW_RANKS)):
                    want[i] += v
            if sent != tuple(want) or span_kernel.LAUNCHES:
                raise AssertionError(
                    f"master/worker {name} excluded={excluded}: sent "
                    f"{sent}, the reference's executor sends {tuple(want)}; "
                    f"K1 launches {span_kernel.LAUNCHES}")
            hold_outputs(torch, got, ref, mm,
                         f"master/worker {name} excluded={excluded}")
            counts.append(f"excluded={excluded}: {sent[0]} ppermutes, "
                          f"{sent[1]} B (reference's executor: {want[0]}, "
                          f"{want[1]} B)")
        region = omp.compile(omp.region(*progs, name=f"{name}_region"),
                             mesh, lowering="master_worker")
        hold_outputs(torch, region(env), ref, mm,
                     f"master/worker {name} as a region")
        print(f"master/worker {name} on {MW_RANKS} ranks: == run_reference "
              f"(1e-4{'; PB_MM_TOL' if mm else ''}) excluded and included "
              f"and as a region staged per loop; " + "; ".join(counts)
              + f"; {time.perf_counter() - t0:.2f} s")
        lows = {
            "master_worker": [omp.compile(p, mesh, lowering="master_worker",
                                          schedule=omp.static())
                              for p in progs],
            "collective": [omp.compile(p, mesh, lowering="collective",
                                       schedule=omp.static())
                           for p in progs],
            "kernel": [omp.compile(p, mesh, lowering="kernel",
                                   schedule=omp.static(), env_like=env)
                       for p in progs]}
        run_ms = {}
        for low, comps in lows.items():
            hold_outputs(torch, run_blocks(comps, env), ref, mm,
                         f"{name} {low} (static)")
            run_ms[low] = cuda_ms(torch, lambda: run_blocks(comps, env),
                                  reps=5, inner=2, warmup=1)
        print(f"times master/worker {name}: Compiled.run master_worker "
              f"{run_ms['master_worker']:.4f} ms, collective "
              f"{run_ms['collective']:.4f} ms, kernel "
              f"{run_ms['kernel']:.4f} ms (static, {MW_RANKS} ranks) on "
              f"{card}")
        del ref, env, lows
        torch.cuda.empty_cache()


def runtime_phase(torch, dev, card):
    """Phase 20: (a) ``ResilientExecutor`` over ``jacobi1d`` (N = 2^24,
    collective) and PolyBench ``gemm`` (EXTRALARGE, kernel lowering) on
    MW_RANKS ranks, a ``FaultPlan`` losing rank MW_LOST: the recovered run
    on the 7-rank mesh equals the healthy one (bit for bit on jacobi1d's
    stencil, PB_MM_TOL on gemm's product), K1 launches on the shrunk mesh
    (a new span source, held against its plain version and timed);
    recovery cold and warm (a second executor that hits the compile
    cache) and the degraded run timed; (b) a NaN at ``run_exit`` caught
    and absorbed by a retry; (c) 16 threads submit one cold program to a
    ``CompileService``: one compile; (d) with ``device_weights`` a
    straggler escalates to one weighted recompile, whose outputs equal
    the unweighted ones.  Returns the kernel-table row of the recovered
    gemm span."""
    from repro_torch import omp
    from repro_torch import polybench as pb
    from repro_torch.core import kernel_lower, transform
    from repro_torch.kernels import span_kernel
    from repro_torch.runtime import (FaultPlan, FaultSpec, ResilientExecutor,
                                     RetryPolicy, StragglerMonitor, inject)
    from repro_torch.serving import CompileService

    mesh = omp.make_mesh((MW_RANKS,), ("data",), device=dev)
    policy = RetryPolicy(max_retries=1)
    lose = FaultPlan(tuple(FaultSpec(call=k, rank=MW_LOST)
                           for k in range(policy.max_retries + 1)))
    jac_blocks, jac_env, _, _ = jacobi1d_program(omp, torch, dev)
    gemm = pb.make("gemm")
    cases = {"jacobi1d": ([p for p, _ in jac_blocks], jac_env, "collective"),
             "gemm": (gemm.programs, gemm.env_fn(dev, seed=0), "kernel")}
    row = None
    for name, (progs, env, low) in cases.items():
        (prog,) = progs
        comp = omp.compile(prog, mesh, lowering=low, schedule=omp.static(),
                           env_like=env)
        healthy = comp(env)
        torch.cuda.synchronize()
        times = {}
        for turn in ("cold", "warm"):
            rex = ResilientExecutor(comp, policy=policy)
            span_kernel.LAUNCHES = 0
            t0 = time.perf_counter()
            with inject(lose) as inj:
                got = rex.run(env)
            torch.cuda.synchronize()
            times[turn] = (time.perf_counter() - t0) * 1e3
            launches = span_kernel.LAUNCHES
            shrunk = rex._degraded[1]
            if not rex.degraded or shrunk.shape["data"] != MW_RANKS - 1 \
                    or len(inj.fired) != policy.max_retries + 1:
                raise AssertionError(f"runtime {name}: no recovery onto "
                                     f"{MW_RANKS - 1} ranks ({rex.stats})")
            for k in healthy:
                if name == "gemm":
                    hold_outputs(torch, {k: got[k]}, {k: healthy[k]}, True,
                                 f"runtime {name} recovered")
                elif not torch.equal(got[k], healthy[k]):
                    raise AssertionError(f"runtime {name} {k}: recovered "
                                         "run differs from the healthy one")
            if low == "kernel" and launches < 1:
                raise AssertionError(f"runtime {name}: K1 did not launch "
                                     "on the shrunk mesh")
        degraded_ms = cuda_ms(torch, lambda: rex.run(env), reps=5, inner=2,
                              warmup=1)
        healthy_ms = cuda_ms(torch, lambda: comp(env), reps=5, inner=2,
                             warmup=1)
        print(f"runtime {name} ({low}): rank {MW_LOST} of {MW_RANKS} lost, "
              f"recovered onto {MW_RANKS - 1} ranks == healthy run "
              f"({'PB_MM_TOL' if name == 'gemm' else 'bit for bit'}); K1 "
              f"launches in the recovered run {launches}; recovery cold "
              f"{times['cold']:.2f} ms, warm {times['warm']:.2f} ms; "
              f"Compiled.run healthy {healthy_ms:.4f} ms, degraded "
              f"{degraded_ms:.4f} ms on {card}")
        if low == "kernel":
            degraded = rex._degraded[0]._compiled
            (dcomp,) = degraded.values()
            if dcomp.kernel_plan.spans[0].ranks != (MW_RANKS - 1,):
                raise AssertionError("runtime gemm: the recovered run's span "
                                     "was not planned for the shrunk mesh")
            label = f"runtime {name} on {MW_RANKS - 1} ranks"
            err, _ = check_pb_span(torch, span_kernel, kernel_lower, dcomp,
                                   prog, env, dev, label, True)
            repl, slabs = transform.stage_inputs(dcomp.plan, env)
            src = dcomp.kernel_plan.spans[0].source
            one = one_stage(kernel_lower, dcomp.plan, prog, slabs, repl)
            ms = cuda_ms(torch, lambda: span_kernel.span_stage_values(
                one, src, dev))
            plain_ms = cuda_ms(torch, lambda: span_kernel.span_values_plain(
                dcomp.plan, prog, slabs, repl, dev))
            nbytes, flops, dot_flops = pb_bound(torch, env, src,
                                                dcomp.plan.nest.total_trip)
            ops_s = pb_ops_s(flops, dot_flops, True)
            bound_s = max(nbytes / HBM_BYTES_PER_S, ops_s)
            lib = pb_library("gemm", torch, env, 0)
            row = {"name": f"span_kernel[recovered gemm {MW_RANKS - 1} "
                           "ranks]", "route": "triton", "source": SOURCE,
                   "replaces": REPLACES, "launches": launches,
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_s * 1e3,
                   "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S >= ops_s
                                else "operations"),
                   "library_ms": cuda_ms(torch, lib) if lib else None}
            print(f"times runtime gemm span on {MW_RANKS - 1} ranks: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{bound_s * 1e3:.4f} ms on {card}")
        # (b) a NaN at run_exit, absorbed by one retry
        rex = ResilientExecutor(comp, policy=policy)
        with inject(FaultPlan((FaultSpec(call=0, kind="nan"),))):
            got = rex.run(env)
        if rex.stats["validation_failures"] != 1 or rex.degraded \
                or not all(torch.equal(got[k], healthy[k]) for k in healthy):
            raise AssertionError(f"runtime {name}: the NaN at run_exit was "
                                 f"not absorbed by a retry ({rex.stats})")
        print(f"runtime {name}: a NaN at run_exit caught by validation and "
              f"absorbed by a retry ({rex.stats})")
        del comp, healthy, got, rex
        torch.cuda.empty_cache()

    # (c) single-flight: 16 threads, one cold program, one compile
    @omp.parallel_for(stop=N1, name="svc_axpy")
    def axpy(i, env):
        return {"y": omp.at(i, 2.0 * env["x"][i] + 1.0)}

    x = torch.randn(N1, device=dev)
    env = {"x": x, "y": torch.zeros(N1, device=dev)}
    want = axpy(env)["y"]
    svc = CompileService(mesh, options=omp.Options(lowering="collective"))
    before = omp.compile_cache_stats()["misses"]
    barrier = threading.Barrier(16)
    outs, errors = [None] * 16, []

    def client(t):
        try:
            barrier.wait()
            outs[t] = svc.run(axpy, env)["y"]
        except BaseException as e:      # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    misses = omp.compile_cache_stats()["misses"] - before
    if svc.stats.cold_compiles != 1 or misses != 1 or not all(
            torch.equal(o, want) for o in outs):
        raise AssertionError(f"compile service: {svc.stats.cold_compiles} "
                             f"compiles, {misses} cache misses for 16 "
                             "racing clients of one program")
    print(f"compile service: 16 threads, one cold program: 1 compile, "
          f"{svc.stats.warm_hits} warm hits, {svc.stats.coalesced} "
          "coalesced, every output == run_reference bit for bit")

    # (d) a straggler escalates to one weighted recompile
    weights = [2.0] + [1.0] * (MW_RANKS - 1)
    svc = CompileService(mesh, options=omp.Options(lowering="collective"),
                         device_weights=weights)
    (prog,) = [p for p, _ in jac_blocks]
    plain = svc.run(prog, jac_env)
    svc.monitor = StragglerMonitor(spike_factor=2.0, spike_budget=3)
    for dt in [0.01] * 20 + [0.2] * 3:
        svc._observe(dt)
    cold = svc.stats.cold_compiles
    weighted = svc.run(prog, jac_env)
    if (svc.stats.rebalances != 1 or svc.stats.evictions != 0
            or svc.stats.cold_compiles != cold + 1
            or svc.options.chunk_weights != tuple(weights)
            or not all(torch.equal(weighted[k], plain[k]) for k in plain)):
        raise AssertionError(f"compile service escalation: "
                             f"{svc.stats.as_dict()}")
    print(f"compile service: a straggler escalated to one weighted "
          f"recompile (weights {weights}), outputs == the unweighted ones "
          f"bit for bit; health rebalanced={svc.health()['rebalanced']}")
    return [row]


# ---------------------------------------------------------------------------
# The persistent compile store across processes
# ---------------------------------------------------------------------------

#: The AOT phase's fresh processes: (label, whether it uses the store,
#: which Triton cache it runs with).
AOT_RUNS = (("a: no store", False, "a"), ("b: empty store", True, "b"),
            ("c: store hit", True, "b"), ("d: store hit, empty Triton cache",
                                          True, "d"))


def aot_programs(omp, torch, dev):
    """``name -> (blocks, env, lowering)`` of the AOT phase: PolyBench
    ``gemm`` (EXTRALARGE, the kernel lowering) and ``jacobi1d`` (N = 2^24,
    collective), on 8 ranks under ``schedule=omp.static()``."""
    from repro_torch import polybench as pb

    gemm = pb.make("gemm")
    jac_blocks, jac_env, _, _ = jacobi1d_program(omp, torch, dev)
    return {"gemm": (gemm.programs, gemm.env_fn(dev, seed=0), "kernel"),
            "jacobi1d": ([p for p, _ in jac_blocks], jac_env, "collective")}


def aot_child(store: str, out_dir: str, device: str = "cuda") -> None:
    """One fresh process of the AOT phase (``python3 -c "import
    chip_smoke; chip_smoke.aot_child(...)"``): each program of
    ``aot_programs`` compiled and run once, with the persistent store at
    ``store`` (none when empty).  Prints one JSON line: per program the
    wall time of its first ``Compiled.run`` (planning, any K1 build and
    the run), whether each block was restored, the store hits it took and
    K1's Triton compiles; saves the outputs under ``out_dir``."""
    torch = _setup()
    from repro_torch import omp
    from repro_torch.kernels import span_kernel

    dev = torch.device(device)
    if store:
        omp.enable_persistent_cache(store)
    mesh = omp.make_mesh((PB_RANKS,), ("data",), device=dev)
    report = {}
    for name, (progs, env, low) in aot_programs(omp, torch, dev).items():
        torch.cuda.synchronize()
        hits, compiles, launches = (omp.compile_cache_stats()["disk_hits"],
                                    span_kernel.COMPILES, span_kernel.LAUNCHES)
        t0 = time.perf_counter()
        comps = [omp.compile(p, mesh, lowering=low, schedule=omp.static())
                 for p in progs]
        out = run_blocks(comps, env)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        torch.save({k: v.cpu() for k, v in out.items()},
                   Path(out_dir) / f"{name}.pt")
        report[name] = {
            "first_run_ms": ms, "restored": [c.restored for c in comps],
            "disk_hits": omp.compile_cache_stats()["disk_hits"] - hits,
            "triton_compiles": span_kernel.COMPILES - compiles,
            "k1_launches": span_kernel.LAUNCHES - launches}
    report["stats"] = omp.compile_cache_stats()
    report["triton_imported"] = "triton" in sys.modules
    print(json.dumps(report))


def aot_phase(torch, card) -> dict:
    """Phase 21: the persistent compile store across processes.  Four
    fresh ``python3`` processes, each with its own Triton cache directory
    (``TRITON_CACHE_DIR``) under a temporary directory, run
    ``aot_programs``: (a) no store; (b) an empty store: cold, and it
    saves (the plans, and after gemm's first run its span kernel's
    cubin); (c) a hit with (b)'s Triton cache; (d) a hit with an empty
    Triton cache.  Hard checks: (c) and (d) restore every block with one
    store hit each; (d) compiles no span kernel (K1 launches the stored
    cubin through ``cuModuleLoadData``) and leaves its Triton cache
    empty; every output equals (a)'s bit for bit.  Returns each run's
    first-run times."""
    import os
    import tempfile

    here = Path(__file__).resolve().parent
    times = {}
    with tempfile.TemporaryDirectory(prefix="aot_phase_") as tmp:
        tmp = Path(tmp)
        store = tmp / "store"
        reports = {}
        for label, use_store, tri in AOT_RUNS:
            out = tmp / f"out_{label[0]}"
            out.mkdir()
            triton_dir = tmp / f"triton_{tri}"
            triton_dir.mkdir(exist_ok=True)
            env = dict(os.environ, TRITON_CACHE_DIR=str(triton_dir))
            code = ("import chip_smoke as c; "
                    f"c.aot_child({str(store) if use_store else ''!r}, "
                    f"{str(out)!r})")
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-c", code], cwd=here,
                                  env=env, capture_output=True, text=True,
                                  timeout=600)
            wall = time.perf_counter() - t0
            if proc.returncode:
                raise AssertionError(f"AOT {label}: the process failed:\n"
                                     f"{proc.stdout[-2000:]}\n"
                                     f"{proc.stderr[-4000:]}")
            rep = reports[label[0]] = json.loads(
                proc.stdout.strip().splitlines()[-1])
            progs = [k for k in rep if k not in ("stats", "triton_imported")]
            times[label[0]] = {k: rep[k]["first_run_ms"] for k in progs}
            print(f"AOT {label}: first Compiled.run "
                  + ", ".join(f"{k} {rep[k]['first_run_ms']:.2f} ms "
                              f"(restored {rep[k]['restored']}, store hits "
                              f"{rep[k]['disk_hits']}, K1 Triton compiles "
                              f"{rep[k]['triton_compiles']})" for k in progs)
                  + f"; store {rep['stats']['persistent_dir'] and 'on'}, "
                  f"{rep['stats']['disk_bytes_written']} B written, "
                  f"{rep['stats']['disk_bytes_read']} B read, errors "
                  f"{rep['stats']['disk_errors']}; triton imported "
                  f"{rep['triton_imported']}; process wall {wall:.1f} s "
                  f"on {card}")
            if rep["stats"]["disk_errors"]:
                raise AssertionError(f"AOT {label}: store errors "
                                     f"{rep['stats']['disk_errors']}")
            for k in progs:
                restored = use_store and label[0] in "cd"
                if rep[k]["restored"] != [restored] * len(rep[k]["restored"]) \
                        or rep[k]["disk_hits"] != (
                            len(rep[k]["restored"]) if restored else 0):
                    raise AssertionError(
                        f"AOT {label} {k}: restored {rep[k]['restored']}, "
                        f"store hits {rep[k]['disk_hits']}")
                if k == "gemm" and not rep[k]["k1_launches"]:
                    raise AssertionError(f"AOT {label}: gemm launched no K1")
                got = torch.load(out / f"{k}.pt")
                want = torch.load(tmp / "out_a" / f"{k}.pt")
                for key in want:
                    if not torch.equal(got[key], want[key]):
                        raise AssertionError(f"AOT {label} {k}/{key}: != "
                                             "(a) bit for bit")
        if not reports["b"]["gemm"]["triton_compiles"]:
            raise AssertionError("AOT b: the cold run compiled no K1")
        if reports["d"]["gemm"]["triton_compiles"] or any(
                (tmp / "triton_d").iterdir()):
            raise AssertionError(
                "AOT d: a store hit compiled through Triton "
                f"({reports['d']['gemm']['triton_compiles']} compiles, "
                f"{len(list((tmp / 'triton_d').iterdir()))} cache entries)")
        print(f"AOT: {len(list(store.iterdir()))} store entries; (c) and (d) "
              "restored every block from one store hit each, (d) compiled "
              "nothing through Triton (its cache stayed empty); every output "
              "== (a) bit for bit")
    return times


# ---------------------------------------------------------------------------
# The MoE and hybrid families: qwen2-moe-a2.7b at full width
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen2-moe-a2.7b"
MOE_F32_LAYERS = 8             # float32 depth: it fits beside the bf16 model
MOE_SERVE_CF = 16.0            # >= e / k = 15: a 4-slot decode tick drops none
MOE_SMOKE = ("jamba-1.5-large-398b", "arctic-480b")
MOE_SMOKE_CF = 8.0             # the reference's high-capacity decode check
MOE_SMOKE_TOL = 2e-4           # its tolerance, prefill + decode vs forward


def moe_config(**changes):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(MOE_ARCH), **changes)


def with_capacity(cfg, factor):
    import dataclasses

    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))


def routed(moe, fn):
    """``fn()`` with every MoE layer's routing recorded (per token and
    expert: not chosen, dropped over capacity, kept): its result, and the
    routing per layer."""
    moe.ROUTES = []
    try:
        out = fn()
    finally:
        routes, moe.ROUTES = moe.ROUTES, None
    return out, routes


def route_agreement(torch, a, b):
    """The share of (token, layer) expert sets that differ between two
    runs' routings (a set differs where an expert is chosen in one run
    and not the other, or kept in one and dropped in the other), per
    token (flattened over the batch, in dispatch order) whether its sets
    agree in every layer, and each run's share of (token, expert) choices
    dropped."""
    same = torch.stack([(x == y).all(-1).reshape(-1) for x, y in zip(a, b)])
    drops = [sum(int((r == 1).sum()) for r in rs)
             / max(1, sum(int((r > 0).sum()) for r in rs)) for rs in (a, b)]
    return 1.0 - same.float().mean().item(), same.all(0), drops


def before_first_flip(torch, ok):
    """Per token (flattened in dispatch order), whether it comes before
    the first token whose routing differs in any layer.  Such a token is
    untouched by every flip: attention is causal within a prompt, the
    second prompt's tokens follow the first's, and an expert's capacity
    slots are dealt in this order."""
    bad = (~ok).nonzero()
    first = int(bad[0, 0]) if bad.numel() else ok.numel()
    return torch.arange(ok.numel(), device=ok.device) < first


def moe_profile(torch, fn, card, wall_ms, label):
    """One prefill under ``torch.profiler``: the card's busy time split
    into K2, the expert products (the ``moe.experts`` ranges), dispatch
    (``moe.dispatch``: routing, top-k, the capacity table, the gather and
    the scatter-add) and the rest, beside the unprofiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = ("moe.experts", "moe.dispatch")
    events = prof.key_averages()
    # the ranges show on the device timeline too (their span there, idle
    # gaps included): the kernels are the other device events
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.key not in names]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy:
        print(f"profile {label}: the profiler recorded no device time")
        return
    k2 = sum(e.self_device_time_total for e in kernels
             if "flash_fwd" in e.key) / 1e3
    # a range's kernels: the device time of the ops it ran on the host
    inside = {n: sum(e.device_time_total for e in events
                     if e.key == n and e.device_type == DeviceType.CPU) / 1e3
              for n in names}
    spans = {n: sum(e.self_device_time_total for e in events
                    if e.key == n and e.device_type == DeviceType.CUDA) / 1e3
             for n in names}
    experts, dispatch = inside["moe.experts"], inside["moe.dispatch"]
    rest = busy - k2 - experts - dispatch
    print(f"profile {label}: kernels busy {busy:.2f} ms, {busy / wall_ms:.1%} "
          f"of the unprofiled {wall_ms:.1f} ms: K2 {k2:.2f} ms "
          f"({k2 / busy:.1%}), expert products {experts:.2f} ms "
          f"({experts / busy:.1%}), dispatch {dispatch:.2f} ms "
          f"({dispatch / busy:.1%}), rest {rest:.2f} ms ({rest / busy:.1%}); "
          f"the ranges' spans on the device: experts "
          f"{spans['moe.experts']:.2f} ms, dispatch "
          f"{spans['moe.dispatch']:.2f} ms on {card}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<5d} "
              f"{e.key[:100]}")


def moe_prefill(torch, dev, cfg, dtype, label):
    """A model of ``cfg`` with weights drawn on the card (seed 0) and
    stored as ``dtype``, its prefill of 2 x ``PREFILL_LEN`` tokens with
    ``impl="kernel"`` against ``impl="chunked"`` (the plain attention),
    computing in ``dtype``: K2 launched once per layer; the share of
    (token, layer) expert sets that differ (chosen, or kept against
    dropped over capacity); every token held where no set differs, else
    the tokens whose sets agree in every layer (``hold_prefill`` on them),
    at ``PREFILL_TOL`` in float32 and ``PREFILL_TOL_BF16`` in bfloat16.
    In bfloat16 also phase 7's second rule: on the tokens whose sets agree
    in three runs, the kernel's gap to the same weights computed in
    float32 (chunked) may not exceed ``BF16_GAP_RATIO`` x the chunked
    path's.  Returns (model, params, the prefill as a function of
    ``impl``, K2 launches, flip share)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model, moe

    t0 = time.perf_counter()
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params, _ = model.init(gen, dtype=dtype)
    tokens = torch.randint(1, cfg.vocab_size, (2, PREFILL_LEN),
                           generator=gen, device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"{label}: {cfg.name}, {cfg.n_layers} layers, {n_params} "
          f"parameters ({dtname(dtype)}, seed 0) built on the card in "
          f"{time.perf_counter() - t0:.2f} s; "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")

    def run(impl, compute=dtype):
        cache = model.init_cache(2, PREFILL_LEN, dtype=compute, device=dev)
        return model.prefill(params, {"tokens": tokens}, cache, impl=impl,
                             compute_dtype=compute)

    fa.LAUNCHES.clear()
    got, r_kernel = routed(moe, lambda: run("kernel"))
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    if launches != {None: cfg.n_layers}:
        raise AssertionError(f"{label}: K2 launched {launches} times by "
                             f"window, want {cfg.n_layers} (global)")
    if got[0].shape != (2, cfg.vocab_size) or not bool(
            torch.isfinite(got[0]).all()):
        raise AssertionError(f"{label}: logits {tuple(got[0].shape)} not "
                             "finite")
    want, r_plain = routed(moe, lambda: run("chunked"))
    if len(r_kernel) != cfg.n_layers or len(r_plain) != cfg.n_layers:
        raise AssertionError(f"{label}: routes of {len(r_kernel)} layers")
    share, ok, drops = route_agreement(torch, r_kernel, r_plain)
    f32 = dtype == torch.float32
    tol = PREFILL_TOL if f32 else PREFILL_TOL_BF16
    if share == 0.0:
        worst = hold_prefill(torch, got, want, tol,
                             f"{label}: impl=kernel != impl=chunked")
        held = "every token"
    else:
        # float32: the tokens no flip reaches, at 1e-4 (a flipped token's
        # values, attended to by every later token of its prompt, move
        # theirs by more than float32's rounding); bfloat16: every token
        # whose own sets agree, at 1e-1
        held_tok = (before_first_flip(torch, ok) if f32 else ok).view(
            2, PREFILL_LEN)
        if not bool(held_tok.any()):
            raise AssertionError(f"{label}: the first token's routing "
                                 "differs; no token is left to hold")
        worst = hold_prefill(torch, got, want, tol,
                             f"{label}: impl=kernel != impl=chunked on the "
                             "tokens whose routing agrees", tokens=held_tok)
        held = (f"the {int(held_tok.sum())} of {ok.numel()} tokens "
                + ("before the first routing flip" if f32
                   else "whose sets agree"))
        if f32:
            agreeing = worst_gap(prefill_pairs(
                got, want, tokens=ok.view(2, PREFILL_LEN)))
            print(f"{label}: on all {int(ok.sum())} tokens whose own sets "
                  f"agree (flips attended to included) the worst err / "
                  f"scale is {agreeing[0]:.3e} in {agreeing[1]}")
    ok = ok.view(2, PREFILL_LEN)
    print(f"{label}: impl=kernel == impl=chunked in {dtname(dtype)} on "
          f"{held} (logits and the k/v caches of all {cfg.n_layers} layers: "
          f"rtol={tol}, atol={tol} x max|value|; worst err / scale "
          f"{worst[0]:.3e} in {worst[1]}); (token, layer) expert sets that "
          f"differ: {share:.3e} of {ok.numel() * cfg.n_layers}; dropped "
          f"over capacity {drops[0]:.3e} / {drops[1]:.3e} of the expert "
          f"choices (kernel / plain); K2 launches by window {launches}")
    if dtype != torch.float32:
        ref, r_ref = routed(moe, lambda: run("chunked", torch.float32))
        _, ok_k, _ = route_agreement(torch, r_kernel, r_ref)
        share_ref, ok_c, _ = route_agreement(torch, r_plain, r_ref)
        all3 = (ok.reshape(-1) & ok_k & ok_c).view(2, PREFILL_LEN)
        gaps = {}
        for impl, out in (("kernel", got), ("chunked", want)):
            gaps[impl], where = worst_gap(prefill_pairs(out, ref,
                                                        tokens=all3))
            print(f"{label}: impl={impl} {dtname(dtype)} against the same "
                  f"weights computed in float32 (chunked) on the "
                  f"{int(all3.sum())} tokens whose sets agree in all three "
                  f"runs: worst err / scale {gaps[impl]:.3e} in {where}")
        if gaps["kernel"] > BF16_GAP_RATIO * gaps["chunked"]:
            raise AssertionError(
                f"{label}: impl=kernel lies {gaps['kernel']:.3e} from "
                f"float32, over {BF16_GAP_RATIO} x impl=chunked's "
                f"{gaps['chunked']:.3e}")
        print(f"{label}: the plain bfloat16 prefill's own sets differ from "
              f"float32's in {share_ref:.3e} of (token, layer)")
        del ref
    del got, want
    return model, params, run, launches, share


def moe_phase(torch, dev, card):
    """Phases 22-23: qwen2-moe-a2.7b at full width and depth in bfloat16
    (``moe_prefill``; times, tokens/s and the profiler's split), served
    (phase 8's engine and teacher-forced check, the capacity factor
    raised to ``MOE_SERVE_CF`` so that a batched decode tick drops no
    token a single-sequence decode keeps), then float32 at
    ``MOE_F32_LAYERS`` layers, and K2 at its shape (B=2, H=KV=16, hd=128,
    S=4096, causal) against its plain version, timed beside SDPA and the
    bound.  Returns the kernel-table rows."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model

    bf16, f32 = torch.bfloat16, torch.float32
    cfg = moe_config()
    model, params, run, launches_bf16, share = moe_prefill(
        torch, dev, cfg, bf16, f"prefill {MOE_ARCH}")
    ms = {impl: cuda_ms(torch, lambda: run(impl), reps=3, inner=1, warmup=1)
          for impl in ("kernel", "chunked")}
    for impl, t in ms.items():
        print(f"end-to-end prefill {MOE_ARCH} impl={impl} bfloat16: "
              f"{t:.2f} ms for 2 x {PREFILL_LEN} tokens, "
              f"{2 * PREFILL_LEN / t * 1e3:.0f} tokens/s on {card}")
    moe_profile(torch, lambda: run("kernel"), card, ms["kernel"],
                f"prefill {MOE_ARCH} bfloat16 impl=kernel")
    serving_phase(torch, dev, card,
                  build_model(with_capacity(cfg, MOE_SERVE_CF)), params)
    del model, params, run
    torch.cuda.empty_cache()
    model, params, run, launches_f32, share32 = moe_prefill(
        torch, dev, moe_config(n_layers=MOE_F32_LAYERS), f32,
        f"prefill {MOE_ARCH} at {MOE_F32_LAYERS} layers")
    del model, params, run
    torch.cuda.empty_cache()

    rows = []
    b, h, kv, s, hd = 2, cfg.n_heads, cfg.n_kv_heads, PREFILL_LEN, \
        cfg.head_dim
    tols = {f32: 2e-5, bf16: 1e-2}
    for dtype, launches in ((bf16, launches_bf16), (f32, launches_f32)):
        q, k, v = k2_inputs(torch, dev, b, h, kv, s, s, hd, dtype, 22)
        fa.LAUNCHES.clear()
        err, row_err = check_k2(torch, fa, q, k, v, True, None,
                                tols[dtype], f"{MOE_ARCH} {dtname(dtype)}")
        if sum(fa.LAUNCHES.values()) != 1:
            raise AssertionError(f"K2 {MOE_ARCH}: launched "
                                 f"{dict(fa.LAUNCHES)} times in one call")
        t = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True))
        plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, causal=True), reps=5, inner=5)
        library_ms = cuda_ms(torch, sdpa_call(torch, q, k, v, None), reps=5,
                             inner=5)
        bound_s, bound_by, flops, nbytes, _ = k2_bound(
            torch, b, h, kv, s, s, hd, None, dtype)
        del q, k, v
        rows.append({
            "name": f"flash_attention[{MOE_ARCH} global S={s} B={b} "
                    f"{dtname(dtype)}]",
            "route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
            "launches": launches.get(None, 0), "max_abs_err": err, "ms": t,
            "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
            "bound_by": bound_by, "library_ms": library_ms})
        print(f"times K2 {MOE_ARCH} {dtname(dtype)} B={b} H={h} KV={kv} "
              f"hd={hd} S={s}: kernel {t:.4f} ms "
              f"({flops / (t * 1e-3) / 1e12:.1f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound "
              f"{bound_s * 1e3:.4f} ms ({bound_by}); max_abs_err {err:.3e}, "
              f"worst row-relative err {row_err:.3e}; K2 launches per "
              f"prefill {launches.get(None, 0)} on {card}")
    print(f"routing flips (kernel vs plain prefill): bfloat16 at "
          f"{cfg.n_layers} layers {share:.3e}, float32 at {MOE_F32_LAYERS} "
          f"layers {share32:.3e} of the (token, layer) expert sets")
    return rows


def moe_smoke_phase(torch, dev, card):
    """Phase 24: jamba-1.5-large-398b (hybrid: SSM and attention layers,
    an MoE FFN every other layer) and arctic-480b (128 experts and a
    dense residual) at ``smoke_config`` size — neither fits the card at
    full width — with weights drawn on the card (seed 0), float32, the
    capacity factor at ``MOE_SMOKE_CF``: a prefill of 21 tokens
    (``impl="kernel"``: K2 on every attention layer) then one decode
    step equals the forward's logits at token 21 (``MOE_SMOKE_TOL``, the
    reference's check); the engine serves 3 requests."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServeEngine

    f32 = torch.float32
    for arch in MOE_SMOKE:
        cfg = with_capacity(smoke_config(arch), MOE_SMOKE_CF)
        model = build_model(cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        params, _ = model.init(gen)
        s = 21
        tokens = torch.randint(1, cfg.vocab_size, (2, s + 1), generator=gen,
                               device=dev, dtype=torch.int32)
        x, aux = model.forward(params, {"tokens": tokens},
                               compute_dtype=f32)
        full = x[:, s] @ model._head_matrix(params)
        cache = model.init_cache(2, 48, dtype=f32, device=dev)
        fa.LAUNCHES.clear()
        _, cache = model.prefill(params, {"tokens": tokens[:, :s]}, cache,
                                 impl="kernel", compute_dtype=f32)
        torch.cuda.synchronize()
        n_attn = sum(cfg.layer_kind(i) == "attn"
                     for i in range(cfg.n_layers))
        if sum(fa.LAUNCHES.values()) != n_attn:
            raise AssertionError(f"{arch}: K2 launched {dict(fa.LAUNCHES)} "
                                 f"times, want {n_attn}")
        logits, _ = model.decode_step(params, cache, tokens[:, s],
                                      torch.full((2,), s, dtype=torch.int32,
                                                 device=dev),
                                      compute_dtype=f32)
        err = (logits - full).abs().max().item()
        torch.testing.assert_close(logits, full, rtol=MOE_SMOKE_TOL,
                                   atol=MOE_SMOKE_TOL)
        engine = ServeEngine(model, params, n_slots=2, cache_len=48,
                             compute_dtype=f32)
        reqs = [Request(rid=i, prompt=tokens[i % 2, :8 + 4 * i].tolist(),
                        max_new_tokens=4) for i in range(3)]
        for r in reqs:
            engine.submit(r)
        done = engine.run_until_drained()
        if sorted(r.rid for r in done) != [0, 1, 2] or any(
                len(r.output) != 4 or not all(0 <= t < cfg.vocab_size
                                              for t in r.output)
                for r in reqs):
            raise AssertionError(f"{arch}: the engine served "
                                 f"{[r.output for r in reqs]}")
        kinds = sorted({blk for blk in model.slot_kinds + model.tail_kinds})
        print(f"smoke {arch}: {cfg.n_layers} layers {kinds}, capacity "
              f"factor {MOE_SMOKE_CF}: prefill of {s} tokens (K2 launches "
              f"{n_attn}) + one decode step == forward at token {s} "
              f"(max abs err {err:.3e}, tol {MOE_SMOKE_TOL}); aux "
              f"{float(aux):.4f}; engine served {len(done)} requests "
              f"{[r.output for r in reqs]} on {card}")
        del model, params, engine
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The encoder-decoder family: whisper-small and K2's three regimes there
# ---------------------------------------------------------------------------

ENCDEC_ARCH = "whisper-small"
WHISPER = dict(requests=4, shortest=4, longest=64, max_new=32,
               cache_len=448)  # 448: the real decoder's cap of positions
WHISPER_TOL = {"float32": PREFILL_TOL, "bfloat16": PREFILL_TOL_BF16}


def arch_config(arch):
    from repro_torch.configs import get_config

    return get_config(arch)


def whisper_config():
    return arch_config(ENCDEC_ARCH)


def whisper_pairs(got, want):
    """(name, got, want) over two whisper prefills' logits and every
    decoder layer's self k/v and cross k/v, as float32."""
    (gl, gc), (wl, wc) = got, want
    pairs = [("logits", gl, wl)]
    for name in ("k", "v"):
        pairs += [(f"self[{i}]/{name}", gc["self"][name][i],
                   wc["self"][name][i])
                  for i in range(wc["self"][name].shape[0])]
    for key in ("cross_k", "cross_v"):
        pairs += [(f"{key}[{i}]", gc[key][i], wc[key][i])
                  for i in range(wc[key].shape[0])]
    return [(n, g.float(), w.float()) for n, g, w in pairs]


def whisper_requests(torch, cfg, dev):
    """``WHISPER["requests"]`` requests: each (frames (1, F, d_model),
    prompt (1, n)), frames normal from seed 0, prompts of 4-64 tokens
    (the first two the shortest and the longest)."""
    import numpy as np

    rng = np.random.default_rng(0)
    lens = rng.integers(WHISPER["shortest"], WHISPER["longest"] + 1,
                        size=WHISPER["requests"])
    lens[:2] = WHISPER["shortest"], WHISPER["longest"]
    g = torch.Generator(device=dev).manual_seed(0)
    return [(torch.randn((1, cfg.encoder.n_frames, cfg.d_model), generator=g,
                         device=dev),
             torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(1, int(n))),
                             dtype=torch.int32, device=dev))
            for n in lens]


def whisper_phase(torch, dev, card):
    """Phase 25: whisper-small at full width and depth (12 encoder and 12
    decoder layers, d_model 768, 12 heads of 64), float32 weights drawn on
    the card from seed 0, computed in float32 and in bfloat16.  For each
    of 4 requests (1500 random frames, a prompt of 4-64 tokens): the
    prefill with impl="kernel" (K2 for the encoder's bidirectional
    self-attention, the decoder's causal self-attention and its
    cross-attention) against impl="full" (``agree`` at ``WHISPER_TOL`` on
    the logits and every layer's self k/v and cross k/v; positions equal;
    in bfloat16 the kernel's gap to float32 at most ``BF16_GAP_RATIO`` x
    the plain path's); K2's launches per encode (12), per prefill (36:
    12 of the encoder, 24 of the decoder) and per decode step (12: the
    cross-attention; the cached self-attention takes impl="full"); then
    32 greedy decode steps, each against a teacher-forced impl="full"
    decode: in float32 every token within ``SERVE_TOL`` x max|logit| of
    the reference's best, in bfloat16 the logits under ``agree`` at
    ``PREFILL_TOL_BF16``; times.  Returns (K2 launches by call, the
    longest prompt)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model

    cfg = whisper_config()
    f32, bf16 = torch.float32, torch.bfloat16
    t0 = time.perf_counter()
    model = build_model(cfg)
    params, _ = model.init(torch.Generator(device=dev).manual_seed(0))
    reqs = whisper_requests(torch, cfg, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"whisper {cfg.name}: {n_params} parameters (float32, seed 0) "
          f"built on the card in {time.perf_counter() - t0:.2f} s; "
          f"{model.n_enc} encoder + {model.n_dec} decoder layers, "
          f"{cfg.encoder.n_frames} frames, prompts "
          f"{[int(p.shape[1]) for _, p in reqs]} tokens, cache_len "
          f"{WHISPER['cache_len']}")

    def prefill(impl, dtype, frames, prompt):
        cache = model.init_cache(1, WHISPER["cache_len"], dtype=dtype,
                                 device=dev)
        return model.prefill(params, {"frames": frames, "tokens": prompt},
                             cache, impl=impl, compute_dtype=dtype)

    def counted(fn):
        fa.LAUNCHES.clear()
        out = fn()
        torch.cuda.synchronize()
        return out, sum(fa.LAUNCHES.values())

    want = {"encode": model.n_enc, "prefill": model.n_enc + 2 * model.n_dec,
            "decode": model.n_dec}
    launches = {}
    for dtype in (f32, bf16):
        tname = dtname(dtype)
        tol = WHISPER_TOL[tname]
        worst = (0.0, "")
        tok_worst, exact, dec_worst = 0.0, 0, 0.0
        for r, (frames, prompt) in enumerate(reqs):
            _, n_enc = counted(lambda: model.encode(
                params, frames, impl="kernel", compute_dtype=dtype))
            got, n_pre = counted(lambda: prefill("kernel", dtype, frames,
                                                 prompt))
            ref = prefill("full", dtype, frames, prompt)
            if got[0].shape != (1, cfg.vocab_size) or not bool(
                    torch.isfinite(got[0]).all()):
                raise AssertionError(f"whisper {tname} request {r}: logits "
                                     f"{tuple(got[0].shape)} not finite")
            if not torch.equal(got[1]["self"]["pos"], ref[1]["self"]["pos"]):
                raise AssertionError(f"whisper {tname} request {r}: "
                                     "self/pos differ")
            worst = max(worst, hold_pairs(
                torch, whisper_pairs(got, ref), tol,
                f"whisper {tname} request {r}: prefill impl=kernel != "
                "impl=full"))
            if dtype == bf16:
                ref32 = prefill("full", f32, frames, prompt)
                gaps = {impl: worst_gap(whisper_pairs(out, ref32))[0]
                        for impl, out in (("kernel", got), ("full", ref))}
                if gaps["kernel"] > BF16_GAP_RATIO * gaps["full"]:
                    raise AssertionError(
                        f"whisper bf16 request {r}: impl=kernel lies "
                        f"{gaps['kernel']:.3e} from float32, over "
                        f"{BF16_GAP_RATIO} x impl=full's {gaps['full']:.3e}")
                del ref32
            (lk, ck), (lf, cf) = got, ref
            pos = prompt.shape[1]
            n_dec = set()
            for t in range(WHISPER["max_new"]):
                tok = int(lk[0].argmax())
                if dtype == f32:
                    row = lf[0]
                    gap = (row.max() - row[tok]).item() / \
                        row.abs().max().item()
                    if gap > SERVE_TOL:
                        raise AssertionError(
                            f"whisper request {r} step {t}: token {tok} "
                            f"scores {gap:.2e} x max|logit| below the "
                            f"teacher-forced reference's best (token "
                            f"{int(row.argmax())}); tolerance {SERVE_TOL}")
                    tok_worst = max(tok_worst, gap)
                    exact += int(row.argmax()) == tok
                else:
                    dec_worst = max(dec_worst, hold_pairs(
                        torch, [("logits", lk.float(), lf.float())], tol,
                        f"whisper bf16 request {r} step {t}: decode "
                        "impl=kernel != impl=full")[0])
                step = (torch.tensor([tok], device=dev),
                        torch.tensor([pos], device=dev))
                (lk, ck), n = counted(lambda: model.decode_step(
                    params, ck, *step, impl="kernel", compute_dtype=dtype))
                n_dec.add(n)
                lf, cf = model.decode_step(params, cf, *step, impl="full",
                                           compute_dtype=dtype)
                pos += 1
            got_n = {"encode": n_enc, "prefill": n_pre,
                     "decode": n_dec.pop() if len(n_dec) == 1 else n_dec}
            if got_n != want:
                raise AssertionError(f"whisper {tname} request {r}: K2 "
                                     f"launches {got_n}, want {want}")
            del got, ref, ck, cf
        launches[tname] = want
        n_new = WHISPER["requests"] * WHISPER["max_new"]
        tail = (f"every greedy token within {SERVE_TOL} x max|logit| of the "
                f"teacher-forced impl=full reference's best (worst "
                f"{tok_worst:.2e}; {exact} of {n_new} equal its argmax)"
                if dtype == f32 else
                f"decode logits impl=kernel == impl=full (agree at {tol}; "
                f"worst err / scale {dec_worst:.3e})")
        print(f"whisper {cfg.name} {tname}: prefill impl=kernel == impl=full "
              f"on {WHISPER['requests']} requests (logits, self k/v and "
              f"cross k/v of all {model.n_dec} decoder layers: rtol={tol}, "
              f"atol={tol} x max|value|; worst err / scale {worst[0]:.3e} "
              f"in {worst[1]}); K2 launches per encode {want['encode']}, "
              f"per prefill {want['prefill']} ({want['encode']} encoder + "
              f"{want['prefill'] - want['encode']} decoder), per decode step "
              f"{want['decode']}; {WHISPER['max_new']} decode steps each: "
              + tail)
    frames, prompt = reqs[1]            # the longest prompt
    for dtype in (bf16, f32):
        tname = dtname(dtype)
        ms = {}
        for impl in ("kernel", "full"):
            ms["encode", impl] = cuda_ms(torch, lambda: model.encode(
                params, frames, impl=impl, compute_dtype=dtype), reps=5,
                inner=3, warmup=1)
            ms["prefill", impl] = cuda_ms(torch, lambda: prefill(
                impl, dtype, frames, prompt), reps=5, inner=3, warmup=1)
        _, cache = prefill("kernel", dtype, frames, prompt)
        step = (torch.tensor([7], device=dev),
                torch.tensor([prompt.shape[1]], device=dev))
        for impl in ("kernel", "full"):
            ms["decode", impl] = cuda_ms(torch, lambda: model.decode_step(
                params, cache, *step, impl=impl, compute_dtype=dtype),
                reps=5, inner=5, warmup=2)
        print(f"end-to-end whisper {tname} (1 request, {prompt.shape[1]}-"
              f"token prompt): encode {ms['encode', 'kernel']:.2f} ms "
              f"(impl=full {ms['encode', 'full']:.2f}), prefill "
              f"{ms['prefill', 'kernel']:.2f} ms (impl=full "
              f"{ms['prefill', 'full']:.2f}), decode step "
              f"{ms['decode', 'kernel']:.3f} ms = "
              f"{1e3 / ms['decode', 'kernel']:.1f} tokens/s (impl=full "
              f"{ms['decode', 'full']:.3f}) on {card}")
        del cache
    del model, params, reqs
    torch.cuda.empty_cache()
    return launches, WHISPER["longest"]


def whisper_k2_rows(torch, dev, card, launches, prompt_len):
    """Phase 26: K2 at whisper's three shapes (B=1, H=KV=12, hd 64, 1500
    keys, no causal mask: the encoder's Sq = 1500 with its ragged last key
    tile, the decoder's cross-attention over the longest prompt, a decode
    step's Sq = 1), bfloat16 and float32, each against its plain version
    (phase 6's ``hold``/``hold_rows`` and their planted faults), then
    timed beside the plain version, SDPA and the bound.  ``launches``:
    phase 25's counts (the decoder-prefill row's 24 are its 12 causal
    self-attention launches and its 12 cross-attention launches).
    Returns the kernel-table rows."""
    from repro_torch.kernels import flash_attention as fa

    cfg = whisper_config()
    h, kv, hd, f = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.encoder.n_frames
    tols = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
    rows = []
    for label, sq, call in (("encoder", f, "encode"),
                            ("decoder prefill cross", prompt_len, "prefill"),
                            ("decode cross", 1, "decode")):
        for dtype in (torch.bfloat16, torch.float32):
            tname = dtname(dtype)
            q, k, v = k2_inputs(torch, dev, 1, h, kv, sq, f, hd, dtype, sq)
            err, row_err = check_k2(torch, fa, q, k, v, False, None,
                                    tols[dtype], f"whisper {label} {tname}")
            ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v,
                                                           causal=False))
            plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, causal=False), reps=5, inner=5)
            library_ms = cuda_ms(torch, lambda: torch.nn.functional.
                                 scaled_dot_product_attention(
                                     q, k, v, enable_gqa=True), reps=5,
                                 inner=5)
            bound_s, bound_by, flops, nbytes, _ = k2_bound(
                torch, 1, h, kv, sq, f, hd, None, dtype, causal=False)
            n = launches[tname][call] - (launches[tname]["encode"]
                                         if call == "prefill" else 0)
            rows.append({
                "name": f"flash_attention[{ENCDEC_ARCH} {label} Sq={sq} "
                        f"Sk={f} {tname}]",
                "route": "cuda", "source": K2_SOURCE,
                "replaces": K2_REPLACES, "launches": n,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_s * 1e3, "bound_by": bound_by,
                "library_ms": library_ms})
            print(f"K2 whisper {label} {tname} B=1 H=KV={h} Sq={sq} Sk={f} "
                  f"hd={hd} bidirectional: kernel == plain (max_abs_err "
                  f"{err:.3e}, worst row-relative {row_err:.3e}, tol "
                  f"{tols[dtype]}); launches per {call} {n}; kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
                  f"{library_ms:.4f} ms, bound {bound_s * 1e3:.4f} ms "
                  f"({bound_by}: {flops} flops, {nbytes} B) on {card}")
            del q, k, v
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Training on one card
# ---------------------------------------------------------------------------

TRAIN_STEP_TOL = 2e-3          # one float32 step, card vs host (sum order)
TRAIN_STEP = dict(arch=ARCH, layers=2, batch=4, seq_len=32)
TRAIN_RUN = dict(archs=(ARCH, ENCDEC_ARCH), batch=8, seq_len=256, steps=30,
                 lr=1e-3)
#: the 30th step's loss on one repeated batch at most this share of the
#: first's (read in a development call; see PERF.md)
TRAIN_LOSS_SHARE = 0.75
FT = dict(steps=8, every=3, fail_at=5, batch=2, seq_len=64, layers=2)


def train_batch(torch, cfg, batch, seq_len, step, dev):
    """The data pipeline's batch of ``step`` on ``dev``."""
    from repro_torch.data import make_batch_iterator

    encdec = cfg.family == "encdec"
    out = next(make_batch_iterator(
        vocab_size=cfg.vocab_size, batch=batch, seq_len=seq_len,
        start_step=step, embed_dim=cfg.d_model if cfg.embedding_stub else None,
        frames=cfg.encoder.n_frames if encdec else None))
    return {k: v.to(dev) for k, v in out.items()}


def train_step_check(torch, dev, card):
    """Phase 27(a): gemma3-1b at full width and 2 layers, one float32
    train step (microbatch 2, remat, AdamW from a state whose second
    moment is filled with 1e-2, clipping, the schedule) on the card and
    the same step on the host's CPU from the same parameters and batch:
    the metrics, every parameter's update, and AdamW's m and v under
    ``agree`` at ``TRAIN_STEP_TOL`` (float32 sums in another order; at a
    zero second moment Adam's first update is lr x g / (|g| + eps), which
    rounding of a gradient near eps could move anywhere in [-lr, lr])."""
    import dataclasses

    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_train_cell
    from repro_torch.pytree import flatten_with_paths, tree_map

    cfg = dataclasses.replace(arch_config(TRAIN_STEP["arch"]),
                              n_layers=TRAIN_STEP["layers"])
    b, s = TRAIN_STEP["batch"], TRAIN_STEP["seq_len"]
    # one rank: a (1, 1) mesh lays nothing out, so the card's step takes
    # the host's tensors' layout
    cell = make_train_cell(cfg, ShapeConfig("check", s, b, "train"),
                           make_local_mesh(device=dev),
                           TrainConfig(compute_dtype="float32", microbatch=2,
                                      warmup_steps=2, total_steps=10,
                                      learning_rate=1e-3))
    params, _ = cell.model.init(torch.Generator(device=dev).manual_seed(0))
    state = cell.optimizer.init(params)
    state["v"] = tree_map(lambda t: torch.full_like(t, 1e-2), state["v"])
    batch = train_batch(torch, cfg, b, s, 0, dev)
    host = torch.device("cpu")
    hp, hs, hb = (tree_to(t, host) for t in (params, state, batch))
    t0 = time.perf_counter()
    gp, gs, gm = cell.step_fn(params, state, batch, 3)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    wp, ws, wm = cell.step_fn(hp, hs, hb, 3)
    host_s = time.perf_counter() - t0
    pairs = [(k, gm[k].float().cpu().reshape(1), wm[k].float().reshape(1))
             for k in ("loss", "ce", "grad_norm", "lr")]
    for tag, (g_tree, w_tree, base) in {
            "update": (gp, wp, hp), "m": (gs["m"], ws["m"], None),
            "v": (gs["v"], ws["v"], None)}.items():
        gn, gl = flatten_with_paths(g_tree)
        _, wl = flatten_with_paths(w_tree)
        bl = flatten_with_paths(base)[1] if base is not None else None
        for i, (n, g, w) in enumerate(zip(gn, gl, wl)):
            g = g.float().cpu()
            if bl is not None:
                g, w = g - bl[i], w - bl[i]
            pairs.append((f"{tag} {n}", g, w.float()))
    worst = hold_pairs(torch, pairs, TRAIN_STEP_TOL,
                       "train step card != host")
    print(f"train step {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}; batch {b} x {s}, "
          f"microbatch 2, remat, float32): card == host CPU ({len(pairs)} "
          f"arrays: the metrics, every parameter's update, AdamW's m and "
          f"v: agree at {TRAIN_STEP_TOL}; worst err / scale "
          f"{worst[0]:.3e} in {worst[1]}); loss {float(gm['loss']):.4f}; "
          f"card {card_s:.2f} s (first call), host {host_s:.2f} s on {card}")


def train_run(torch, dev, card, arch):
    """Phase 27(b): ``arch`` at full width and depth, AdamW, remat,
    bfloat16 compute, one batch of 8 x 256 from the data pipeline taken
    30 times (lr 1e-3, warm-up 3): the last loss at most
    ``TRAIN_LOSS_SHARE`` of the first; ms per step and tokens/s.
    Returns (first loss, last loss)."""
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_train_cell

    cfg = arch_config(arch)
    b, s, n = TRAIN_RUN["batch"], TRAIN_RUN["seq_len"], TRAIN_RUN["steps"]
    cell = make_train_cell(cfg, ShapeConfig("run", s, b, "train"),
                           make_local_mesh(device=dev),
                           TrainConfig(compute_dtype="bfloat16", remat=True,
                                      warmup_steps=3, total_steps=n,
                                      learning_rate=TRAIN_RUN["lr"]))
    torch.cuda.reset_peak_memory_stats()
    params, _ = cell.model.init(torch.Generator(device=dev).manual_seed(0))
    state = cell.optimizer.init(params)
    batch = train_batch(torch, cfg, b, s, 0, dev)
    losses, times = [], []
    for step in range(n):
        t0 = time.perf_counter()
        params, state, m = cell.step_fn(params, state, batch, step)
        losses.append(float(m["loss"]))         # waits for the step
        times.append(time.perf_counter() - t0)
        if not math.isfinite(losses[-1]):
            raise AssertionError(f"train {arch} step {step}: loss "
                                 f"{losses[-1]}")
    step_ms = statistics.median(times[2:]) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"train {arch}: {n_params} parameters (float32), AdamW, remat, "
          f"bfloat16 compute, microbatch {cell.n_micro}, one batch of "
          f"{b} x {s} tokens {n} times: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} ({losses[-1] / losses[0]:.3f} of the first; "
          f"every 5th: {[round(x, 3) for x in losses[::5]]}); "
          f"{step_ms:.1f} ms a step (median of steps 3-{n}), "
          f"{b * s / step_ms * 1e3:.0f} tokens/s, first step "
          f"{times[0] * 1e3:.0f} ms, peak memory {peak:.1f} GiB on {card}")
    if not losses[-1] <= TRAIN_LOSS_SHARE * losses[0]:
        raise AssertionError(
            f"train {arch}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, above "
            f"{TRAIN_LOSS_SHARE} of the first")
    del params, state, batch, cell
    torch.cuda.empty_cache()
    return losses[0], losses[-1]


def ft_child(out: str, device: str = "cuda") -> None:
    """Phase 27(c), in a fresh process (``CUBLAS_WORKSPACE_CONFIG`` set and
    ``torch.use_deterministic_algorithms(True)`` before the card is
    touched): whisper-small at full width with 2 encoder and 2 decoder
    layers, ``FT["steps"]`` float32 train steps on the data pipeline's
    batches under ``FaultTolerantLoop`` (async checkpoints every
    ``FT["every"]`` steps), once uninterrupted and once with a
    ``StepFailure`` planted at step ``FT["fail_at"]`` and a restore from
    the last checkpoint; writes the comparison as JSON to ``out``."""
    import dataclasses
    import os
    import tempfile

    torch = _setup() if device == "cuda" else __import__("torch")
    torch.use_deterministic_algorithms(True)
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_train_cell
    from repro_torch.pytree import flatten_with_paths
    from repro_torch.runtime import FaultTolerantLoop, StepFailure

    dev = torch.device(device)
    base = whisper_config()
    cfg = dataclasses.replace(base, n_layers=FT["layers"], encoder=dataclasses.
                              replace(base.encoder, n_layers=FT["layers"]))
    cell = make_train_cell(cfg, ShapeConfig("ft", FT["seq_len"], FT["batch"],
                                            "train"),
                           make_local_mesh(device=dev),
                           TrainConfig(compute_dtype="float32", warmup_steps=2,
                                      total_steps=FT["steps"],
                                      learning_rate=1e-3))

    def run(ckpt_dir, fail_at):
        params, _ = cell.model.init(torch.Generator(device=dev).manual_seed(0))
        failed = []

        def hook(step):
            if step == fail_at and not failed:
                failed.append(step)
                raise StepFailure(f"planted at step {step}")

        def step_fn(state, step):
            batch = train_batch(torch, cfg, FT["batch"], FT["seq_len"], step,
                                dev)
            p, s, _ = cell.step_fn(*state, batch, step)
            return p, s

        loop = FaultTolerantLoop(step_fn=step_fn,
                                 checkpointer=Checkpointer(ckpt_dir,
                                                           keep=1),
                                 checkpoint_every=FT["every"], backoff_s=0.0,
                                 failure_hook=hook)
        t0 = time.perf_counter()
        state = loop.run((params, cell.optimizer.init(params)), start_step=0,
                         num_steps=FT["steps"])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return state, loop.restores, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        want, r0, s0 = run(os.path.join(tmp, "a"), None)
        got, r1, s1 = run(os.path.join(tmp, "b"), FT["fail_at"])
    names, gl = flatten_with_paths(got)
    wl = flatten_with_paths(want)[1]
    differ = [n for n, g, w in zip(names, gl, wl) if not torch.equal(g, w)]
    with open(out, "w") as f:
        json.dump({"leaves": len(names), "differ": differ,
                   "restores": [r0, r1], "seconds": [s0, s1],
                   "deterministic": torch.are_deterministic_algorithms_enabled()
                   }, f)


def train_phase(torch, dev, card):
    """Phase 27: training on one card — (a) ``train_step_check``, (b)
    ``train_run`` for gemma3-1b and whisper-small, (c) ``ft_child`` in a
    fresh process: the recovered run equals the uninterrupted one bit for
    bit."""
    import os
    import tempfile

    train_step_check(torch, dev, card)
    torch.cuda.empty_cache()
    for arch in TRAIN_RUN["archs"]:
        train_run(torch, dev, card, arch)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ft.json")
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c",
                        f"import chip_smoke as c; c.ft_child({out!r})"],
                       cwd=Path(__file__).resolve().parent, env=env,
                       check=True, timeout=600)
        with open(out) as f:
            got = json.load(f)
    if got["differ"] or got["restores"] != [0, 1] \
            or not got["deterministic"]:
        raise AssertionError(f"fault-tolerant loop: {got}")
    print(f"fault-tolerant loop {ENCDEC_ARCH} ({FT['layers']} + "
          f"{FT['layers']} layers, full width, float32, deterministic "
          f"algorithms): {FT['steps']} steps, checkpoints every "
          f"{FT['every']}, a StepFailure at step {FT['fail_at']} restored "
          f"once: all {got['leaves']} parameter and state leaves equal the "
          f"uninterrupted run's bit for bit; runs {got['seconds'][0]:.2f} / "
          f"{got['seconds'][1]:.2f} s; child {time.perf_counter() - t0:.1f} "
          f"s on {card}")


# ---------------------------------------------------------------------------
# Training across ranks on the stacked mesh, MoE groups, GPipe, the int8
# all-reduce and the train_lm example
# ---------------------------------------------------------------------------

#: phase 28(a): gemma3-1b at full width and 2 layers, one float32 step
MESH_STEP = dict(layers=2, batch=4, seq_len=32, mesh=(2, 2))
#: the (2, 2) ZeRO-3 step vs the (1, 1) step: the per-rank gradients,
#: summed by psum, are float32 sums in another order; as in phase 27(a),
#: a gated-MLP weight's gradient sums nearly cancelling terms (a
#: development call read 7.380e-04 there; see PERF.md)
MESH_STEP_TOL = 2e-3
#: phase 28(b): full depth, bf16 compute, remat, 12 steps on one batch
#: on each mesh, the first ``warmup`` untimed: ms a step is the median of
#: the other 10
MESH_RUN = dict(batch=8, seq_len=256, steps=12, warmup=2, mesh=(2, 2),
                lr=1e-3)
#: the (2, 2) run's first 3 losses at most this share from the (1, 1)
#: run's (development calls read 9.4e-06 and 9.5e-06; see PERF.md), and
#: all 12 at most ``MESH_LOSS_SHARE_ALL``: bf16 sums in another order
#: drift apart as the runs train on one batch (a development call read
#: 3.926e-03 at step 10)
MESH_LOSS_SHARE = 1e-3
MESH_LOSS_SHARE_ALL = 1e-2
#: phase 29: qwen2-moe-a2.7b at full width and 2 layers, float32, on a
#: (2, 1) mesh (MoE groups 2) against a one-rank step at groups 2
MOE_STEP = dict(layers=2, batch=4, seq_len=32, mesh=(2, 1))
MOE_STEP_TOL = 1e-3
#: phase 30: whisper-small's encoder as GPipe stages
GPIPE = dict(stages=4, micro=4)
GPIPE_F32_TOL = 1e-4           # pipeline vs sequential autograd, float32
ALLREDUCE_RANKS = 4            # phase 31's data ranks
TRAIN_LM_STEPS = 200           # phase 32


def mesh_cell(dev, cfg, shape, mesh_shape, train_cfg):
    """``make_train_cell`` over a ``mesh_shape`` (data, model) stacked
    mesh on ``dev``."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_train_cell

    return make_train_cell(cfg, shape, make_local_mesh(
        mesh_shape[1], ranks=mesh_shape[0] * mesh_shape[1], device=dev),
        train_cfg)


def layout_note(cell) -> str:
    """How many parameter leaves the cell stores as per-rank blocks."""
    specs = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            specs.append(t)
    walk(cell.param_specs)
    sharded = sum(1 for sp in specs if any(
        cell.mesh.shape[a] > 1 for e in sp
        for a in ((e,) if isinstance(e, str) else (e or ()))))
    return f"{sharded} of {len(specs)} parameter leaves stored as blocks"


def step_pairs(torch, got, want, base):
    """(name, got, want) pairs over two steps' metrics, every parameter's
    update from ``base`` and every optimizer-state leaf, as float32."""
    from repro_torch.pytree import flatten_with_paths

    (gp, gs, gm), (wp, ws, wm) = got, want
    pairs = [(k, gm[k].float().reshape(1), wm[k].float().reshape(1))
             for k in ("loss", "ce", "aux", "grad_norm", "lr")]
    names, bl = flatten_with_paths(base)
    for n, g, w, b in zip(names, flatten_with_paths(gp)[1],
                          flatten_with_paths(wp)[1], bl):
        pairs.append((f"update {n}", (g - b).float(), (w - b).float()))
    names, wl = flatten_with_paths(ws)
    for n, g, w in zip(names, flatten_with_paths(gs)[1], wl):
        if g.dtype.is_floating_point:
            pairs.append((f"state {n}", g.float(), w.float()))
    return pairs


def mesh_step_check(torch, dev, card):
    """Phase 28(a): gemma3-1b at full width and 2 layers, one float32
    step (microbatch 2, AdamW from a second moment filled with 1e-2,
    clipping, the schedule) on a (2, 2) stacked mesh with ZeRO-3 against
    the (1, 1) step on the same batch: the metrics, every parameter's
    update and AdamW's m and v under ``agree`` at ``MESH_STEP_TOL``; the
    mesh's launches and bytes by collective."""
    import dataclasses

    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.pytree import tree_map

    cfg = dataclasses.replace(arch_config(ARCH), n_layers=MESH_STEP["layers"])
    b, s = MESH_STEP["batch"], MESH_STEP["seq_len"]
    shape = ShapeConfig("mesh", s, b, "train")
    tcfg = TrainConfig(compute_dtype="float32", microbatch=2, zero3=True,
                       warmup_steps=2, total_steps=10, learning_rate=1e-3)
    one = mesh_cell(dev, cfg, shape, (1, 1), tcfg)
    many = mesh_cell(dev, cfg, shape, MESH_STEP["mesh"], tcfg)
    params, _ = one.model.init(torch.Generator(device=dev).manual_seed(0))
    state = one.optimizer.init(params)
    state["v"] = tree_map(lambda t: torch.full_like(t, 1e-2), state["v"])
    batch = train_batch(torch, cfg, b, s, 0, dev)
    want = one.step_fn(params, state, batch, 3)
    placed = many.place(params, state)
    many.mesh.reset_counters()
    t0 = time.perf_counter()
    gp, gs, gm = many.step_fn(*placed, batch, 3)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches, nbytes = dict(many.mesh.launches), dict(many.mesh.bytes)
    got = (*many.gather(gp, gs), gm)
    pairs = step_pairs(torch, got, want, params)
    worst = hold_pairs(torch, pairs, MESH_STEP_TOL,
                       f"train step {MESH_STEP['mesh']} ZeRO-3 != (1, 1)")
    print(f"train across ranks {cfg.name} ({cfg.n_layers} layers, full "
          f"width; batch {b} x {s}, microbatch 2, float32): one step on a "
          f"{MESH_STEP['mesh']} stacked mesh with ZeRO-3 ({layout_note(many)}"
          f") == the (1, 1) step ({len(pairs)} arrays: the metrics, every "
          f"parameter's update, AdamW's m and v: agree at {MESH_STEP_TOL}; "
          f"worst err / scale {worst[0]:.3e} in {worst[1]}); collectives "
          f"{launches}, bytes {nbytes}; {step_s:.2f} s (first call) on "
          f"{card}")
    del params, state, placed, got, want
    torch.cuda.empty_cache()


def mesh_run(torch, dev, card):
    """Phase 28(b): gemma3-1b at full width and depth, bf16 compute,
    remat, AdamW, ``MESH_RUN["steps"]`` steps on one 8 x 256 batch, on the
    (1, 1) mesh and on a (2, 2) mesh with ZeRO-3 from the same weights:
    the first 3 losses within ``MESH_LOSS_SHARE`` of the (1, 1) run's,
    all within ``MESH_LOSS_SHARE_ALL``; ms per
    step on each mesh (the median of the steps after the warm-up) and
    their ratio, and the (2, 2) mesh's bytes per step by collective."""
    from repro_torch.configs import ShapeConfig, TrainConfig

    cfg = arch_config(ARCH)
    b, s, n = MESH_RUN["batch"], MESH_RUN["seq_len"], MESH_RUN["steps"]
    w = MESH_RUN["warmup"]
    shape = ShapeConfig("mesh-run", s, b, "train")
    tcfg = TrainConfig(compute_dtype="bfloat16", remat=True, zero3=True,
                       warmup_steps=1, total_steps=n,
                       learning_rate=MESH_RUN["lr"])
    batch = train_batch(torch, cfg, b, s, 0, dev)
    runs = {}
    for mesh_shape in ((1, 1), MESH_RUN["mesh"]):
        cell = mesh_cell(dev, cfg, shape, mesh_shape, tcfg)
        torch.cuda.reset_peak_memory_stats()
        params, _ = cell.model.init(torch.Generator(device=dev).manual_seed(0))
        state = cell.place(params)
        del params
        cell.mesh.reset_counters()
        losses, times = [], []
        for step in range(n):
            t0 = time.perf_counter()
            state = cell.step_fn(*state, batch, step)
            losses.append(float(state[2]["loss"]))  # waits for the step
            times.append(time.perf_counter() - t0)
            state = state[:2]
            if not math.isfinite(losses[-1]):
                raise AssertionError(f"train {mesh_shape} step {step}: loss "
                                     f"{losses[-1]}")
        runs[mesh_shape] = dict(
            losses=losses, ms=statistics.median(times[w:]) * 1e3,
            first_ms=times[0] * 1e3,
            bytes={k: v // n for k, v in cell.mesh.bytes.items()},
            launches={k: v // n for k, v in cell.mesh.launches.items()},
            peak=torch.cuda.max_memory_allocated() / 2**30,
            micro=cell.n_micro, note=layout_note(cell))
        del state, cell
        torch.cuda.empty_cache()
    one, many = runs[(1, 1)], runs[MESH_RUN["mesh"]]
    gaps = [abs(a - w) / abs(w) for a, w in zip(many["losses"],
                                                one["losses"])]
    for mesh_shape, r in runs.items():
        print(f"train across ranks {cfg.name} on {mesh_shape} (full width "
              f"and depth, ZeRO-3, AdamW, remat, bf16 compute, microbatch "
              f"{r['micro']}, one batch of {b} x {s} tokens {n} times; "
              f"{r['note']}): losses {[round(x, 4) for x in r['losses']]}; "
              f"{r['ms']:.1f} ms a step (median of steps {w + 1}-{n}), first "
              f"{r['first_ms']:.0f} ms, {b * s / r['ms'] * 1e3:.0f} tokens/s"
              f", peak memory {r['peak']:.1f} GiB; collectives a step "
              f"{r['launches']}, bytes a step {r['bytes']} on {card}")
    for first, limit in ((3, MESH_LOSS_SHARE), (n, MESH_LOSS_SHARE_ALL)):
        if max(gaps[:first]) > limit:
            raise AssertionError(
                f"train {MESH_RUN['mesh']} losses {many['losses']} lie up "
                f"to {max(gaps[:first]):.3e} of the (1, 1) losses "
                f"{one['losses']} in the first {first} steps, over {limit}")
    print(f"train across ranks: the {MESH_RUN['mesh']} losses lie within "
          f"{max(gaps[:3]):.3e} of the (1, 1) losses in the first 3 steps "
          f"(limit {MESH_LOSS_SHARE}), {max(gaps):.3e} in all {n} (limit "
          f"{MESH_LOSS_SHARE_ALL}); "
          f"a step takes {many['ms'] / one['ms']:.3f}x the (1, 1) step's "
          f"(medians of steps {w + 1}-{n} in this phase) "
          f"on {card}")


def mesh_train_phase(torch, dev, card):
    """Phase 28: training across ranks on the stacked mesh."""
    mesh_step_check(torch, dev, card)
    mesh_run(torch, dev, card)


def moe_mesh_phase(torch, dev, card):
    """Phase 29: qwen2-moe-a2.7b at full width and 2 layers, float32,
    Adafactor: one step on a (2, 1) stacked mesh (MoE groups = the
    data-parallel degree, 2: each rank's rows are one dispatch group)
    against a one-rank step built with groups 2 (``launch.steps.
    _dp_degree`` bound to 2 while the cell is built), on the same batch:
    the routing of every token equal, then the metrics, every
    parameter's update and the factored second moments under ``agree``
    at ``MOE_STEP_TOL``."""
    import dataclasses

    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.launch import steps
    from repro_torch.models import moe

    cfg = moe_config(n_layers=MOE_STEP["layers"])
    b, s = MOE_STEP["batch"], MOE_STEP["seq_len"]
    shape = ShapeConfig("moe-mesh", s, b, "train")
    tcfg = TrainConfig(optimizer="adafactor", compute_dtype="float32",
                       remat=False, microbatch=1, warmup_steps=2,
                       total_steps=10, learning_rate=1e-3)
    many = mesh_cell(dev, cfg, shape, MOE_STEP["mesh"], tcfg)
    dp = MOE_STEP["mesh"][0]
    old = steps._dp_degree
    steps._dp_degree = lambda mesh: dp
    try:
        one = mesh_cell(dev, cfg, shape, (1, 1), tcfg)
    finally:
        steps._dp_degree = old
    params, _ = one.model.init(torch.Generator(device=dev).manual_seed(0))
    batch = train_batch(torch, cfg, b, s, 0, dev)
    moe.ROUTES = []
    try:
        want = one.step_fn(params, one.optimizer.init(params), batch, 3)
        want_routes, moe.ROUTES = moe.ROUTES, []
        placed = many.place(params)
        many.mesh.reset_counters()
        t0 = time.perf_counter()
        gp, gs, gm = many.step_fn(*placed, batch, 3)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        got_routes = moe.ROUTES
    finally:
        moe.ROUTES = None
    # the one-rank step routes (groups, T, E) per layer; the mesh's ranks
    # route their own group, rank by rank, each over every layer
    layers = len(want_routes)
    got = [torch.cat([got_routes[r * layers + i] for r in range(dp)])
           for i in range(layers)]
    flips = sum(int((g != w).any(-1).sum()) for g, w in zip(got,
                                                            want_routes))
    dropped = sum(int((w == 1).sum()) for w in want_routes) / max(
        1, sum(int((w > 0).sum()) for w in want_routes))
    if flips:
        raise AssertionError(f"MoE across ranks: {flips} tokens routed "
                             "otherwise than the one-rank step at groups "
                             f"{dp}")
    pairs = step_pairs(torch, (*many.gather(gp, gs), gm), want, params)
    worst = hold_pairs(torch, pairs, MOE_STEP_TOL,
                       f"MoE step {MOE_STEP['mesh']} != one rank at groups "
                       f"{dp}")
    print(f"MoE across ranks {cfg.name} ({cfg.n_layers} layers, full width "
          f"(d_model {cfg.d_model}, {cfg.moe.n_experts} experts, top "
          f"{cfg.moe.top_k}); batch {b} x {s}, float32, Adafactor): one "
          f"step on a {MOE_STEP['mesh']} mesh (groups {dp}: each rank's rows"
          f" one dispatch group) == a one-rank step at groups {dp}: every "
          f"token's routing equal ({dropped:.3f} of the expert choices "
          f"dropped over capacity), {len(pairs)} arrays agree at "
          f"{MOE_STEP_TOL} (worst err / scale {worst[0]:.3e} in "
          f"{worst[1]}); collectives {dict(many.mesh.launches)}; "
          f"{step_s:.2f} s (first call) on {card}")
    del params, placed, want, gp, gs
    torch.cuda.empty_cache()


def gpipe_phase(torch, dev, card):
    """Phase 30: whisper-small's encoder at full width and depth as GPipe
    stages: 12 blocks as 4 stages of 3 on a 4-rank stacked mesh, 4
    microbatches of one utterance of 1500 frames.  (a) bfloat16, K2
    (impl="kernel"), no grad: the pipeline's outputs equal the 12 blocks
    applied in order with impl="full" under ``agree`` at
    ``PREFILL_TOL_BF16``; M+S-1 ``ppermute`` launches; K2 launches
    S x 3 x (M+S-1) (the lockstep bubble included); (b) float32, the
    plain attention, ``checkpoint=True``: outputs and the gradients of
    every stacked encoder parameter equal sequential autograd under
    ``agree`` at ``GPIPE_F32_TOL``; (c) ms per pipeline forward beside
    the sequential blocks; K2 on the q, k, v of one launch made inside a
    tick against its plain version, timed beside SDPA and the bound.
    Returns K2's kernel-table row."""
    from repro_torch.core.pipeline import make_pipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.mesh import make_mesh
    from repro_torch.models import blocks as blk
    from repro_torch.models import build_model
    from repro_torch.pytree import flatten_with_paths, tree_map, unflatten_like

    cfg = whisper_config()
    n_st, m = GPIPE["stages"], GPIPE["micro"]
    model = build_model(cfg)
    params, _ = model.init(torch.Generator(device=dev).manual_seed(0))
    enc = params["encoder"]
    per = model.n_enc // n_st
    f, d = cfg.encoder.n_frames, cfg.d_model
    g = torch.Generator(device=dev).manual_seed(1)
    frames = torch.randn((m, 1, f, d), generator=g, device=dev)
    mesh = make_mesh((n_st,), ("stage",), device=dev)
    kind = "attn:global:dense"

    def blocks(p, x, first, count, impl):
        pos = torch.arange(x.shape[1], dtype=torch.int32,
                           device=dev).expand(x.shape[0], x.shape[1])
        for i in range(first, first + count):
            x = blk.block_apply(tree_map(lambda t: t[i], p), x, cfg, kind,
                                positions=pos, impl=impl,
                                attn_mode="bidir")[0]
        return x

    def stage(impl):
        return lambda p, x: blocks(p, x, 0, per, impl)

    def stacked(tree):
        return tree_map(lambda t: t.reshape((n_st, per) + t.shape[1:]), tree)

    def sequential(tree, x, impl):
        return blocks(tree, x.reshape(m, f, d), 0, model.n_enc, impl)

    # (a) bfloat16, K2
    enc16 = tree_map(lambda t: t.to(torch.bfloat16), enc)
    x16 = frames.to(torch.bfloat16)
    run = make_pipeline(stage("kernel"), mesh, axis="stage", checkpoint=False)
    captured = []
    launch = fa.flash_attention

    def capture(q, k, v, **kw):
        if not captured:
            captured.append((q.clone(), k.clone(), v.clone(), kw))
        return launch(q, k, v, **kw)

    fa.flash_attention = capture
    try:
        with torch.no_grad():
            run(stacked(enc16), x16)            # warm-up
            torch.cuda.synchronize()
            mesh.reset_counters()
            fa.LAUNCHES.clear()
            got = run(stacked(enc16), x16)
            torch.cuda.synchronize()
    finally:
        fa.flash_attention = launch
    n_k2, n_pp = sum(fa.LAUNCHES.values()), mesh.launches["ppermute"]
    want_k2 = n_st * per * (m + n_st - 1)
    if n_pp != m + n_st - 1 or n_k2 != want_k2:
        raise AssertionError(f"GPipe: {n_pp} ppermute launches (want "
                             f"{m + n_st - 1}), K2 launched {n_k2} times "
                             f"(want {want_k2})")
    with torch.no_grad():
        want = sequential(enc16, x16, "full")
    worst16 = hold_pairs(torch, [("outputs", got.reshape(m, f, d).float(),
                                  want.float())], PREFILL_TOL_BF16,
                         "GPipe bf16 impl=kernel != sequential impl=full")
    # (b) float32, plain attention, checkpointed stages, gradients
    names, flat = flatten_with_paths(enc)
    leaves = [t.detach().requires_grad_(True) for t in flat]
    tree = unflatten_like(enc, leaves)
    run32 = make_pipeline(stage("full"), mesh, axis="stage", checkpoint=True)
    out = run32(stacked(tree), frames)
    gp = torch.autograd.grad(out.square().mean(), leaves)
    ref = sequential(tree, frames, "full")
    gs = torch.autograd.grad(ref.square().mean(), leaves)
    pairs = [("outputs", out.detach().reshape(m, f, d), ref.detach())]
    pairs += [(f"grad {n}", a, b) for n, a, b in zip(names, gp, gs)]
    worst32 = hold_pairs(torch, pairs, GPIPE_F32_TOL,
                         "GPipe float32 != sequential autograd")
    del out, ref, gp, gs, leaves, tree
    # (c) times and K2 inside a tick
    with torch.no_grad():
        pipe_ms = cuda_ms(torch, lambda: run(stacked(enc16), x16), reps=5,
                          inner=2, warmup=1)
        seq_ms = cuda_ms(torch, lambda: sequential(enc16, x16, "kernel"),
                         reps=5, inner=2, warmup=1)
    q, k, v, kw = captured[0]
    tol = 1e-2
    err, row_err = check_k2(torch, fa, q, k, v, kw.get("causal", True),
                            kw.get("window"), tol, "GPipe tick encoder bf16")
    ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, **kw))
    plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v, **kw),
                       reps=5, inner=5)
    library_ms = cuda_ms(torch, lambda: torch.nn.functional.
                         scaled_dot_product_attention(q, k, v,
                                                      enable_gqa=True),
                         reps=5, inner=5)
    b_, h, sq, hd = q.shape
    bound_s, bound_by, flops, nbytes, _ = k2_bound(
        torch, b_, h, k.shape[1], sq, k.shape[2], hd, None, q.dtype,
        causal=False)
    print(f"GPipe {cfg.name} encoder ({model.n_enc} blocks as {n_st} stages "
          f"of {per} on a {n_st}-rank stacked mesh, {m} microbatches of one "
          f"utterance of {f} frames): bf16 impl=kernel == the blocks in "
          f"order with impl=full (agree at {PREFILL_TOL_BF16}; worst err / "
          f"scale {worst16[0]:.3e}); float32 plain attention, checkpointed "
          f"stages: outputs and the gradients of all {len(names)} stacked "
          f"encoder leaves == sequential autograd (agree at {GPIPE_F32_TOL};"
          f" worst err / scale {worst32[0]:.3e} in {worst32[1]}); ppermute "
          f"launches per forward {n_pp} (M+S-1), K2 launches {n_k2} "
          f"(S x {per} x (M+S-1): the lockstep bubble's "
          f"{n_k2 - m * model.n_enc} beyond the {m * model.n_enc} of the "
          f"blocks in order); "
          f"{pipe_ms:.2f} ms per pipeline forward, {seq_ms:.2f} ms for the "
          f"blocks in order (bf16, K2) on {card}")
    print(f"K2 in a GPipe tick B={b_} H={h} Sq={sq} Sk={k.shape[2]} hd={hd} "
          f"bidirectional bfloat16: kernel == plain (max_abs_err {err:.3e}, "
          f"worst row-relative {row_err:.3e}, tol {tol}); launches per "
          f"pipeline forward {n_k2}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound "
          f"{bound_s * 1e3:.4f} ms ({bound_by}: {flops} flops, {nbytes} B) "
          f"on {card}")
    del model, params, enc, enc16, captured, q, k, v
    torch.cuda.empty_cache()
    return [{
        "name": f"flash_attention[{ENCDEC_ARCH} encoder in a GPipe tick "
                f"({n_st} stages x {per} blocks, {m} microbatches) Sq={sq} "
                f"Sk={f} bfloat16]",
        "route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
        "launches": n_k2, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_s * 1e3, "bound_by": bound_by,
        "library_ms": library_ms}]


def allreduce_phase(torch, dev, card):
    """Phase 31: ``compressed_allreduce_tree`` over ``ALLREDUCE_RANKS``
    data ranks of gemma3-1b's full gradient tree (every parameter's
    shape; normal values at 1e-3, each rank its own draw; zero error
    feedback), leaf by leaf: the int8 mean within the two-hop
    quantisation bound of the float mean (per leaf: the mean over ranks
    of max|g_r| / 254 for the first hop, max|float mean| / 254 for the
    second, 1% for float rounding); the counted bytes beside those of a
    float ``psum`` of the same gradients."""
    from repro_torch.launch.steps import param_shapes
    from repro_torch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import compressed_allreduce_tree
    from repro_torch.pytree import flatten_with_paths

    p = ALLREDUCE_RANKS
    cfg = arch_config(ARCH)
    names, shapes = flatten_with_paths(param_shapes(build_model(cfg))[0])
    mesh = make_mesh((p,), ("data",), device=dev)
    floats = make_mesh((p,), ("data",), device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    worst, n_elems, c_ms = (0.0, ""), 0, 0.0
    for name, shp in zip(names, shapes):
        grads = torch.randn((p,) + tuple(shp.shape), generator=g,
                            device=dev) * 1e-3
        errs = torch.zeros_like(grads)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        means, new_errs = compressed_allreduce_tree(
            {name: grads}, {name: errs}, mesh=mesh, axis="data")
        torch.cuda.synchronize()
        c_ms += (time.perf_counter() - t0) * 1e3
        want = floats.psum(grads, "data") / p
        bound = 1.01 * (grads.abs().flatten(1).amax(1).mean().item()
                        + want.abs().max().item()) / 254
        err = (means[name] - want).abs().max().item()
        if not err <= bound or not bool(torch.isfinite(new_errs[name]).all()):
            raise AssertionError(f"int8 all-reduce {name}: max err {err:.3e}"
                                 f" over its bound {bound:.3e}")
        worst = max(worst, (err / bound, name))
        n_elems += shp.numel()
        del grads, errs, means, new_errs, want
    compressed = sum(mesh.bytes.values())
    if not compressed < floats.bytes["psum"] / 2:
        raise AssertionError(f"int8 all-reduce: {compressed} B counted, a "
                             f"float psum {floats.bytes['psum']} B")
    print(f"int8 all-reduce over {p} data ranks of {cfg.name}'s gradient "
          f"tree ({len(names)} leaves, {n_elems} values a rank): every "
          f"leaf's mean within its two-hop int8 bound of the float mean "
          f"(worst err / bound {worst[0]:.3f} in {worst[1]}); counted "
          f"{dict(mesh.launches)} moving {compressed} B against a float "
          f"psum's {floats.bytes['psum']} B "
          f"({compressed / floats.bytes['psum']:.3f} of it); "
          f"{c_ms:.1f} ms over the tree on {card}")
    torch.cuda.empty_cache()


def train_lm_phase(torch, card):
    """Phase 32: ``python -m repro_torch.examples.train_lm --steps 200``
    on the card in a fresh process: it passes its own check (the last
    logged loss at least 0.5 below the first)."""
    import os
    import tempfile

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.examples.train_lm",
             "--steps", str(TRAIN_LM_STEPS), "--ckpt-dir", tmp], cwd=root,
            env=env, capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
        saved = sorted(os.listdir(tmp))
    if out.returncode != 0 or "OK: the pipeline learns" not in out.stdout:
        raise AssertionError(f"train_lm example exit {out.returncode}:\n"
                             f"{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
    summary = [ln for ln in out.stdout.splitlines() if ln.startswith("loss")]
    print(f"train_lm example ({TRAIN_LM_STEPS} steps on the card, "
          f"checkpoints {saved}): {summary[-1] if summary else '?'}; passes "
          f"its learning check; {secs:.1f} s in a fresh process on {card}")


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
                one = one_stage(kernel_lower, comp.plan, prog, slabs, repl)
                ms += cuda_ms(torch, lambda: span_kernel.span_stage_values(
                    one, src, dev))
                plain_ms += cuda_ms(torch, lambda: span_kernel.
                                    span_values_plain(comp.plan, prog, slabs,
                                                      repl, dev))
                # each env array the body reads, once; each output's
                # values on the loop's iterations, once
                trip = comp.plan.nest.total_trip
                b = sum(env[key].numel() * env[key].element_size()
                        for _, _, key in src.inputs)
                b += sum(trip * math.prod(shape[3 * prog.rank:])
                         * torch.empty((), dtype=dt).element_size()
                         for _, _, shape, dt in src.outputs)
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

    # -- regions: whole programs, fused / staged / kernel --------------------
    rows += region_phase(torch, dev, card)

    # -- PolyBench linear algebra: K1's products on tl.dot -------------------
    rows += polybench_phase(torch, dev, card)

    # -- repairs: K1's scans and rolls, K2 past head_dim 256 -----------------
    rows += repair_phase(torch, dev, card)
    rows += k2_wide_phase(torch, dev, card)

    # -- master/worker (paper Fig. 1b) and the runtime -----------------------
    master_worker_phase(torch, dev, card)
    rows += runtime_phase(torch, dev, card)

    # -- the persistent compile store across processes ----------------------
    torch.cuda.empty_cache()
    aot_phase(torch, card)

    # -- MoE and hybrid: qwen2-moe-a2.7b at full width, jamba and arctic -----
    rows += moe_phase(torch, dev, card)
    moe_smoke_phase(torch, dev, card)

    # -- the encoder-decoder family: whisper-small, K2 without a mask ------
    launches, prompt_len = whisper_phase(torch, dev, card)
    rows += whisper_k2_rows(torch, dev, card, launches, prompt_len)

    # -- training on one card -----------------------------------------------
    train_phase(torch, dev, card)

    # -- training across ranks, MoE groups, GPipe, the int8 all-reduce -----
    mesh_train_phase(torch, dev, card)
    moe_mesh_phase(torch, dev, card)
    rows += gpipe_phase(torch, dev, card)
    allreduce_phase(torch, dev, card)
    train_lm_phase(torch, card)

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
