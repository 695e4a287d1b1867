#!/usr/bin/env python3
"""K1's launch: the launcher against Triton's own launch path, in turns.

    python3 tools/k1_launch_cost.py              # every span
    python3 tools/k1_launch_cost.py atax bicg    # these PolyBench kernels
    python3 tools/k1_launch_cost.py --out results/launch.json

For every span of the PolyBench kernels of ``repro_torch.polybench``
(EXTRALARGE, 8 ranks, ``static``) and of ``chip_smoke.py``'s region
programs, each way of launching the same compiled kernel is timed in
turns (``chip_smoke.launch_turns``: launcher, Triton, launcher, Triton;
the median of each way's turns is kept):

* ``launcher``: ``span_kernel.span_stage_values``, the wrapper the
  executor calls (``launch_span``: one C call into the compiled kernel,
  the outputs views into one allocation);
* ``triton``: ``span_kernel.launch_span_triton``, Triton's Python launch
  path (its binder, specialisation and cache lookup per call) into one
  ``torch.empty`` per output, as K1 launched before.

Per span: the host's time to enqueue one call, calls back to back (CUDA
events; a short span's host sets it) and the device time alone
(``chip_smoke.device_ms``), and the two outputs equal bit for bit on the
lanes that hold an iteration.  For each block of atax and bicg, the
host's time a call alone (3000 calls, the card waited for after) of the
launcher, of ``torch.empty`` of its outputs and of the library call that
computes the block.  Then ``Compiled.run`` of atax, bicg, mvt,
gesummv and jacobi2d with the executor's spans launched each way
(Triton, launcher, launcher, Triton).  Prints one line per span and
writes them as JSON to ``--out`` (default
``build/k1_launch_cost.json``); needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUN_KERNELS = ("atax", "bicg", "mvt", "gesummv", "jacobi2d")
HOST_KERNELS = ("atax", "bicg")


def main(names, out: Path) -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    torch = cs._setup()
    from repro_torch import omp
    from repro_torch import polybench as pb
    from repro_torch.core import kernel_lower, transform
    from repro_torch.kernels import span_kernel

    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"card: {card}")

    def old_launch(source, stage_io, device):
        span_kernel.LAUNCHES += 1
        return span_kernel.launch_span_triton(source, stage_io, device)

    new_launch = span_kernel.launch_span

    def ways(stages, source):
        io = [(st.ext_windows, st.env_repl) for st in stages]
        return {"launcher": lambda: span_kernel.span_stage_values(
                    stages, source, dev),
                "triton": lambda: span_kernel.launch_span_triton(
                    source, io, dev)}

    def measure(label, stages, source):
        cs.hold_launch_bits(torch, kernel_lower, span_kernel, source, stages,
                            dev, label)
        got = cs.launch_turns(torch, ways(stages, source))
        row = {"span": label, **{f"{w}_{m}_ms": v for w, t in got.items()
                                 for m, v in zip(("b2b", "device", "host"),
                                                 t)}}
        print(f"{label}: host enqueue {row['launcher_host_ms']:.4f} ms "
              f"(launcher) vs {row['triton_host_ms']:.4f} (Triton); back to "
              f"back {row['launcher_b2b_ms']:.4f} vs "
              f"{row['triton_b2b_ms']:.4f}"
              f"; device {row['launcher_device_ms']:.4f} vs "
              f"{row['triton_device_ms']:.4f}; outputs equal bit for bit")
        return row

    def host_ms(fn, calls=3000):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t = (time.perf_counter() - t0) * 1e3 / calls
        torch.cuda.synchronize()
        return t

    rows, runs = [], []
    mesh = omp.make_mesh((cs.PB_RANKS,), ("data",), device=dev)
    for name in names or pb.LINEAR_ALGEBRA + pb.STENCILS:
        kernel = pb.make(name)
        env = kernel.env_fn(dev, seed=0)
        comps = [omp.compile(p, mesh, lowering="kernel",
                             schedule=omp.static(), env_like=env)
                 for p in kernel.programs]
        cs.run_blocks(comps, env)       # Triton builds each kernel
        benv = env
        for prog, comp in zip(kernel.programs, comps):
            repl, slabs = transform.stage_inputs(comp.plan, benv)
            one = cs.one_stage(kernel_lower, comp.plan, prog, slabs, repl)
            src = comp.kernel_plan.spans[0].source
            rows.append(measure(f"polybench {name}/{prog.name}", one, src))
            lib = cs.pb_library(name, torch, benv,
                                kernel.programs.index(prog))
            if name in HOST_KERNELS and lib is not None:
                t = {"launcher": host_ms(lambda: span_kernel.
                                         span_stage_values(one, src, dev)),
                     "empty": host_ms(lambda: [
                         torch.empty(shape, dtype=dt, device=dev)
                         for _, _, shape, dt in src.outputs]),
                     "library": host_ms(lib)}
                rows[-1].update({f"host_only_{k}_ms": v
                                 for k, v in t.items()})
                print(f"host only polybench {name}/{prog.name}: launcher "
                      f"{t['launcher']:.4f} ms a call, torch.empty of its "
                      f"outputs {t['empty']:.4f}, the library call "
                      f"{t['library']:.4f}")
            benv = comp(benv)
        if name in RUN_KERNELS:
            t = {"launcher": [], "triton": []}
            for w in ("triton", "launcher", "launcher", "triton"):
                span_kernel.launch_span = (new_launch if w == "launcher"
                                           else old_launch)
                try:
                    t[w].append(cs.cuda_ms(torch, lambda: cs.run_blocks(
                        comps, env), reps=5, inner=3, warmup=2))
                finally:
                    span_kernel.launch_span = new_launch
            run = {"kernel": name, **{f"{w}_run_ms": statistics.median(v)
                                      for w, v in t.items()}}
            runs.append(run)
            print(f"Compiled.run polybench {name}: "
                  f"{run['triton_run_ms']:.4f} ms (Triton's launch path) -> "
                  f"{run['launcher_run_ms']:.4f} ms (launcher)")
        del comps, env, benv
        torch.cuda.empty_cache()
    if not names:
        for name, (reg, env, shape, axes) in cs.region_programs(
                omp, torch, dev).items():
            comp = omp.compile(reg, omp.make_mesh(shape, axes, device=dev),
                               lowering="kernel", env_like=env)
            comp(env)
            for stages, source in cs.record_spans(span_kernel,
                                                  lambda: comp(env)):
                rows.append(measure(
                    f"region {name}/"
                    + "+".join(st.plan.name for st in stages), stages,
                    source))
            del comp, env
            torch.cuda.empty_cache()
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "spans": rows, "runs": runs},
                              indent=1))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("names", nargs="*",
                        help="PolyBench kernels (default: all, and regions)")
    parser.add_argument("--out", type=Path,
                        default=ROOT / "build" / "k1_launch_cost.json")
    args = parser.parse_args()
    raise SystemExit(main(args.names, args.out))
