#!/usr/bin/env python3
"""Time ``Mesh.psum``'s rank-order fold against one ``sum`` over the rank
dim, on a block program whose merge is a full-array scatter.

    python3 tools/psum_fold_cost.py [--n N]

The program writes ``z[3 i + 1] = x[i] + 3`` (a strided write, merged as
a masked full-array psum of ``z``'s buffer and its int32 mask) and sums
``x`` into ``s`` (a reduce psum, fused with the buffer under the
aggregate schedule), over N = 2^24 iterations by default on 8 ranks.
Compiled with ``lowering="collective"`` under the aggregate and the
inline schedule, each is timed (``Compiled.run``, CUDA events) with the
fold and with ``Mesh.psum`` swapped for ``x.sum(rank dims)``, in the
order fold, sum, sum, fold; the psum of the buffer alone is timed both
ways too.  Prints whether aggregate equals inline bit for bit under each
psum, and the card's name and power limit.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 24)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    torch = cs._setup()
    from repro_torch import mesh as mesh_mod
    from repro_torch import omp

    dev, n, p = torch.device("cuda"), args.n, 8
    fold = mesh_mod.Mesh.psum

    def one_sum(self, x, axis):
        names = self._axes(axis)
        self._check(x, names)
        self._count("psum", x, math.prod(self.shape[a] for a in names))
        return x.sum(dim=tuple(range(len(names))))

    @omp.parallel_for(stop=n, reduction={"s": "+"}, name="scatter")
    def scatter(i, env):
        return {"z": omp.at(3 * i + 1, env["x"][i] + 3.0),
                "s": omp.red(env["x"][i])}

    g = torch.Generator(device=dev).manual_seed(0)
    env = {"x": torch.randn(n, generator=g, device=dev),
           "z": torch.zeros(3 * n, device=dev),
           "s": torch.zeros((), device=dev)}
    mesh = omp.make_mesh((p,), ("data",), device=dev)
    comps = {mode: omp.compile(scatter, mesh, lowering="collective",
                               comm_schedule=mode, env_like=env)
             for mode in ("aggregate", "inline")}
    print(f"card: {cs.card_line()}")
    print(f"scatter merge: P={p}, N={n}, z of {3 * n} float32; strategies "
          f"{ {k: d.out_strategy for k, d in comps['inline'].plan.vars.items()} }")
    times: dict = {}
    outs: dict = {}
    buf = torch.randn((p, 3 * n), generator=g, device=dev)
    for label, impl in (("fold", fold), ("sum", one_sum), ("sum", one_sum),
                        ("fold", fold)):
        mesh_mod.Mesh.psum = impl
        try:
            for mode, comp in comps.items():
                outs[label, mode] = comp(env)
                times.setdefault((label, mode), []).append(cs.cuda_ms(
                    torch, lambda: comp(env), reps=7, inner=3, warmup=2))
            times.setdefault((label, "psum alone"), []).append(cs.cuda_ms(
                torch, lambda: mesh.psum(buf, "data"), reps=7, inner=5))
        finally:
            mesh_mod.Mesh.psum = fold
    for key, ts in times.items():
        print(f"{key[0]:>4} {key[1]:>10}: " + ", ".join(f"{t:.4f}"
                                                        for t in ts)
              + " ms")
    for label in ("fold", "sum"):
        same = all(torch.equal(outs[label, "aggregate"][k],
                               outs[label, "inline"][k])
                   for k in outs[label, "inline"])
        print(f"{label}: aggregate == inline bit for bit: {same}")
    for k in ("z", "s"):
        torch.testing.assert_close(outs["fold", "inline"][k],
                                   outs["sum", "inline"][k])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
