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

The last two lines are the kernel table as one JSON object and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
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


def main(device: str = "cuda") -> int:
    sys.stdout.reconfigure(line_buffering=True)
    torch = _setup()
    import triton

    from repro_torch import omp
    from repro_torch.core import kernel_lower, transform
    from repro_torch.kernels import span_kernel

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

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_blocks(blocks, env):
    """Run blocks in order (compiled programs or ParallelFor references),
    each seeing the previous one's outputs."""
    for b in blocks:
        env = b(env)
    return env


if __name__ == "__main__":
    raise SystemExit(main())
