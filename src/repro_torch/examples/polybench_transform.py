"""PolyBench through the compiler: schedules and lowerings compared — the
counterpart of ``examples/polybench_transform.py``.

Transforms the gemm kernel under every schedule clause and both
lowerings, prints the paper-Tables-2/3-style reports, and contrasts the
communication volume of the faithful master/worker pattern (paper
Fig. 1b: all traffic through rank 0) against the balanced collective
lowering.

This example doubles as the **legacy-shim demonstration**: the final
execution check runs once through ``omp.compile`` (the current API) and
once through the deprecated ``omp.to_mpi`` shim, showing that the shim
emits a ``DeprecationWarning`` and produces identical results.  Runs on
the CUDA card unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python -m repro_torch.examples.polybench_transform
"""
import argparse
import warnings

import torch

from repro_torch import omp
from repro_torch.core.plan import make_plan
from repro_torch.core.report import _comm_summary, render_plan
from repro_torch.mesh import resolve_device
from repro_torch.polybench import make_gemm


def comm_total(plan) -> int:
    return int(_comm_summary(plan)[-1].split("~")[1].split()[0])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    k = make_gemm(ni=args.n)
    gemm = k.programs[0]
    env = k.env_fn(device)
    ranks = args.ranks

    print("=" * 70)
    print(f"gemm under the three schedule clauses ({ranks} ranks)")
    print("=" * 70)
    for sched in (omp.static(), omp.dynamic(), omp.guided()):
        gemm.schedule = sched
        plan = make_plan(gemm, env, ranks)
        print(f"\nschedule({sched.kind}): chunk={plan.chunks.chunk}, "
              f"{plan.chunks.num_chunks} chunks, "
              f"comm ~{comm_total(plan)} B")

    gemm.schedule = omp.dynamic()
    print()
    print("=" * 70)
    print("collective vs master/worker lowering (the paper's Fig. 1b)")
    print("=" * 70)
    p_col = make_plan(gemm, env, ranks, lowering="collective")
    p_mw = make_plan(gemm, env, ranks, lowering="master_worker")
    c, m = comm_total(p_col), comm_total(p_mw)
    print(f"\ncollective   : ~{c/1e6:.2f} MB moved")
    print(f"master/worker: ~{m/1e6:.2f} MB moved "
          f"({m/c:.1f}x — all through rank 0's links)")

    print()
    print(render_plan(p_col))

    # execute and verify against the shared-memory reference, through
    # the current API and through the deprecated shim (same result,
    # plus a DeprecationWarning pointing at omp.compile)
    mesh = omp.make_mesh((ranks,), ("data",), device=device)
    ref = gemm(env)
    out = omp.compile(gemm, mesh, lowering="collective")(env)
    torch.testing.assert_close(out["C"], ref["C"], rtol=1e-4, atol=1e-4)
    print("\nexecution check (collective lowering): OK")

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        legacy = omp.to_mpi(gemm, mesh)(env)
    deprecations = [w for w in caught
                    if issubclass(w.category, DeprecationWarning)]
    assert deprecations
    torch.testing.assert_close(legacy["C"], out["C"], rtol=1e-6, atol=0)
    print("legacy omp.to_mpi shim: DeprecationWarning emitted "
          f"({deprecations[0].message}), output identical")
    return out


if __name__ == "__main__":
    main()
