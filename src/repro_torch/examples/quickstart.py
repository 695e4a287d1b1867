"""Quickstart: the paper's Table 1 program, transformed — the counterpart
of ``examples/quickstart.py``.

Reproduces the paper's running example — an OpenMP program with two
parallel blocks (an array computation and a reduction) — through the
whole OMP2MPI pipeline: shared-memory reference execution, context
analysis, the generated distribution plan (the Tables 2/3 analogue), and
the distributed execution on a stacked mesh of ``--ranks`` ranks,
verified equal.  Runs on the CUDA card unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--n 1000]
"""
import argparse

import torch

from repro_torch import omp
from repro_torch.mesh import resolve_device


def table1(n: int):
    """The paper's Table 1 program for ``n`` iterations: its two
    blocks."""
    # #pragma omp parallel for target mpi
    # for (i=0; i<N; ++i) sum[i] = 4.0/(1.0 + x*x);
    @omp.parallel_for(stop=n, schedule=omp.dynamic(), name="table1_block1")
    def block1(i, env):
        x = (i + 0.5) / n
        return {"sum": omp.at(i, 4.0 / (1.0 + x * x))}

    # #pragma omp parallel for reduction(+: total)
    # for (i=0; i<N; ++i) total += sum[i];
    @omp.parallel_for(stop=n, reduction={"total": "+"},
                      name="table1_block2")
    def block2(i, env):
        return {"total": omp.red(env["sum"][i] / n)}

    return block1, block2


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    block1, block2 = table1(args.n)
    env = {"sum": torch.zeros(args.n, device=device),
           "total": torch.zeros((), device=device)}

    # 1) shared-memory ("OpenMP") execution — the reference
    ref = block2(block1(env))
    print(f"OpenMP reference:   pi ~= {float(ref['total']):.6f}")

    # 2) the OMP2MPI transformation — the staged compiler pipeline
    #    (analyze -> schedule -> plan -> plan_comm -> lower)
    mesh = omp.make_mesh((args.ranks,), ("data",), device=device)
    d1 = omp.compile(block1, mesh, env_like=env)
    d2 = omp.compile(block2, mesh, env_like=block1(env))
    print("\npipeline:", " -> ".join(p.name for p in d1.passes))

    # 3) the generated "MPI program" report (paper Tables 2/3 analogue)
    print()
    print(d1.report())
    print()
    print(d2.report())

    # 4) distributed execution — correct by construction
    out = d2(d1(env))
    print(f"\nMPI (transformed):  pi ~= {float(out['total']):.6f}")
    torch.testing.assert_close(out["total"], ref["total"], rtol=1e-6,
                               atol=0)
    print("transform == reference: OK")
    return float(out["total"])


if __name__ == "__main__":
    main()
