#!/usr/bin/env python3
"""``Compiled.run`` of two trees of the port, timed on one card in turns.

    python3 tools/host_path_turns.py --tree parent=build/parent \\
        --tree change=. --order parent,change,change,parent \\
        --out build/host_path_turns.json

Each turn is one process that imports ``repro_torch`` from its tree's
``src/`` (the program builders and the timer are this checkout's
``chip_smoke.py``, so every tree runs the same programs the same way) and
times, with ``chip_smoke.cuda_ms`` (CUDA events, the median of 7 runs of
3 calls back to back):

* the region programs of ``chip_smoke.region_programs`` under every
  lowering of ``chip_smoke.REGION_LOWERINGS`` (the smoke's phase 16);
* the PolyBench kernels of ``repro_torch.polybench`` at EXTRALARGE on 8
  ranks, ``static``, under the collective and the kernel lowering (the
  smoke's phase 17).

Every run is first held against the shared-memory run (1e-4).  Prints
one line per program with each turn's time and the median of each tree,
the card's name and power limit, and writes every number as JSON to
``--out``.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def worker(src: str) -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("host_path_turns: torch.cuda.is_available() is false")
    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    import repro_torch
    from repro_torch import omp
    from repro_torch import polybench as pb

    if not Path(repro_torch.__file__).resolve().is_relative_to(
            Path(src).resolve()):
        raise AssertionError(f"repro_torch from {repro_torch.__file__}, "
                             f"not from {src}")
    dev = torch.device("cuda")

    def check(got, ref, label):
        for k in ref:
            torch.testing.assert_close(got[k], ref[k], rtol=1e-4, atol=1e-4,
                                       msg=lambda m: f"{label} {k}: {m}")

    def ms(fn):
        return cs.cuda_ms(torch, fn, reps=7, inner=3, warmup=2)

    out = {"region": {}, "polybench": {}}
    for name, (reg, env, shape, axes) in cs.region_programs(
            omp, torch, dev).items():
        mesh = omp.make_mesh(shape, axes, device=dev)
        ref = reg(env)
        row = out["region"][name] = {}
        for low, opts in cs.REGION_LOWERINGS.items():
            comp = omp.compile(reg, mesh, env_like=env, **opts)
            check(comp(env), ref, f"region {name}/{low}")
            row[low] = ms(lambda: comp(env))
        del env, ref
        torch.cuda.empty_cache()
    mesh = omp.make_mesh((cs.PB_RANKS,), ("data",), device=dev)
    for name in pb.LINEAR_ALGEBRA + pb.STENCILS:
        kernel = pb.make(name)
        env = kernel.env_fn(dev, seed=0)
        ref = cs.run_blocks(kernel.programs, env)
        row = out["polybench"][name] = {}
        for low in ("collective", "kernel"):
            comps = [omp.compile(p, mesh, lowering=low, schedule=omp.static(),
                                 env_like=env) for p in kernel.programs]
            check(cs.run_blocks(comps, env), ref, f"polybench {name}/{low}")
            row[low] = ms(lambda: cs.run_blocks(comps, env))
        del env, ref
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="label=path of a checkout (repeat)")
    ap.add_argument("--order", default="",
                    help="comma-separated labels, one process each")
    ap.add_argument("--out", default="build/host_path_turns.json")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)))
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order.split(",") if args.order else list(trees)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    turns = []
    for label in order:
        src = str((Path(trees[label]) / "src").resolve())
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, __file__, "--worker", src],
                             capture_output=True, text=True, timeout=1200)
        if res.returncode:
            sys.stderr.write(res.stdout[-4000:] + res.stderr[-8000:])
            raise SystemExit(f"turn {label} failed ({res.returncode})")
        turns.append((label, json.loads(res.stdout.strip().splitlines()[-1])))
        print(f"turn {len(turns)} {label}: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    table = []
    for part in ("region", "polybench"):
        for name, lows in turns[0][1][part].items():
            for low in lows:
                per = [(lab, r[part][name][low]) for lab, r in turns]
                med = {lab: statistics.median(t for la, t in per if la == lab)
                       for lab in trees}
                table.append({"part": part, "program": name, "lowering": low,
                              "turns": per, "median_ms": med})
                print(f"{part} {name} {low}: "
                      + ", ".join(f"{lab} {t:.4f}" for lab, t in per)
                      + " ms; median " + ", ".join(
                          f"{lab} {t:.4f}" for lab, t in med.items())
                      + f" ms on {card}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "order": order,
                               "trees": trees, "rows": table}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
