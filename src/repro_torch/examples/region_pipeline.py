"""ParallelRegion: a whole OpenMP program transformed at once — the
counterpart of ``examples/region_pipeline.py``.

The paper transforms each ``parallel for`` in isolation, so consecutive
loops round-trip their data through rank 0 (Fig. 1b).  This example
builds the multi-block program

    // #pragma omp parallel for          (sweep: u[i] = a[i]/2 + 1)
    // #pragma omp parallel for          (square: v[i] = u[i]^2)
    // serial glue                       (scale = 1/sqrt(sum))
    // #pragma omp parallel for reduction(+: total)

as ONE :class:`~repro_torch.core.pragma.ParallelRegion`, transforms it
with ``omp.compile`` (fused lowering), prints the inter-loop residency
plan (which buffers stay distributed across loop boundaries, which need
a minimal reshard), and verifies the fused execution against the
shared-memory reference — then contrasts it with the paper's per-loop
staging.  Runs on the CUDA card unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python -m repro_torch.examples.region_pipeline
"""
import argparse

import torch

from repro_torch import omp
from repro_torch.mesh import resolve_device


def pipeline(n: int):
    """The region of ``n`` iterations a loop."""

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

    return omp.region(sweep, square, sumsq, rescale, normalize,
                      name="pipeline")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n = args.n
    program = pipeline(n)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    env = {"a": torch.arange(n, dtype=torch.float32, device=device),
           "u": zeros(n), "v": zeros(n), "ss": zeros(), "scale": zeros(1),
           "y": zeros(n)}

    # 1) shared-memory ("OpenMP") execution — the oracle
    ref = program(env)
    print(f"OpenMP reference:   ||y|| ~= {float((ref['y'] ** 2).sum()):.6f}")

    # 2) the whole-program transformation (Lowering.FUSED is the
    #    default: arrays resident between loops)
    mesh = omp.make_mesh((args.ranks,), ("data",), device=device)
    dist = omp.compile(program, mesh, env_like=env)

    # 3) the residency plan — the whole-program analogue of Tables 2/3
    print()
    print(dist.report())

    # 4) fused distributed execution — correct by construction
    out = dist(env)
    for k in ref:
        torch.testing.assert_close(out[k], ref[k], rtol=1e-4, atol=1e-4)
    print("\nfused transform == reference: OK "
          f"({dist.plan.n_elided} resident handoffs, "
          f"{dist.plan.n_reshards} reshards)")

    # 5) contrast with the paper's per-loop staging
    staged = omp.compile(program, mesh, lowering="collective")
    out_staged = staged(env)
    torch.testing.assert_close(out_staged["y"], ref["y"], rtol=1e-4,
                               atol=1e-4)
    print("per-loop staged execution matches too — but every loop "
          "boundary round-trips its buffers")
    return out


if __name__ == "__main__":
    main()
