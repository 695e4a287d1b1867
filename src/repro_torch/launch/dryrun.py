"""Production-mesh dry run: build and lower every (arch x shape x mesh)
cell on the ``meta`` device — the counterpart of
:mod:`repro.launch.dryrun`.

For every cell this script:

1. builds the step (train / prefill / decode) with the tensor planner's
   specs (:func:`repro_torch.launch.steps.make_cell`) on the stacked
   production mesh (:func:`repro_torch.launch.mesh.make_production_mesh`,
   256 or 512 ranks on ``meta``),
2. runs it once on ``meta`` tensors (:func:`repro_torch.launch.steps.
   lower_cell`): no memory is allocated and no kernel runs, so it needs
   no GPU,
3. records the per-rank argument bytes (``memory``), the products'
   FLOPs and the counted collectives with their wire cost (``step``,
   :mod:`repro_torch.launch.audit`), and the roofline terms at the card's
   rates (``roofline``),
4. writes one JSON per cell to ``--out`` (existing cells are skipped, so
   the sweep is resumable); a cell that fails records ``"status":
   "error"`` and the traceback.

What the record cannot hold: ``meta`` has no allocator, so there is no
temporary or peak memory (the reference reads XLA's
``memory_analysis()``); ``memory.temp_bytes`` and
``memory.peak_per_device_gb`` are ``null``, with the reason.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-1b --shape prefill_32k
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback


def cell_id(arch: str, shape: str, mesh_name: str) -> str:
    return f"{arch}__{shape}__{mesh_name}"


def should_skip(cfg, shape) -> str | None:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("long_500k skipped: pure full attention "
                "(DESIGN.md §4)")
    return None


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             *, force: bool = False, layers: int | None = None) -> dict:
    """Build, lower and audit one cell; its record (read back from
    ``out_dir`` when it is there and ``force`` is false).  ``layers``
    cuts the model's depth (the record's ``n_layers`` says so): lowering
    runs the step's Python loops on ``meta`` at ~0.3-0.5 ms an op, and a
    train cell on the production mesh runs one forward and backward pass
    per data rank and microbatch (128 for ``train_4k`` on pod16x16)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import audit
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import lower_cell, make_cell

    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cid = cell_id(arch, shape_name, mesh_name)
    if layers is not None:
        cid += f"__{layers}L"
    path = os.path.join(out_dir, cid + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    shape = SHAPES[shape_name]
    record: dict = {
        "cell": cid, "arch": arch, "shape": shape_name,
        "mesh": mesh_name, "kind": shape.kind, "n_layers": cfg.n_layers,
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
    }
    skip = should_skip(cfg, shape)
    if skip:
        record["status"] = "skipped"
        record["reason"] = skip
        _write(path, record)
        return record

    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        n_dev = math.prod(mesh.shape.values())
        cell = make_cell(cfg, shape, mesh)
        t_build = time.time() - t0
        low = lower_cell(cell)
        t_lower = time.time() - t0 - t_build
        rep = audit.StepReport.from_lowered(low)
        # the stacked mesh runs the global step's products once; a rank's
        # share is taken as an even split over the mesh's ranks
        flops = rep.dot_flops / n_dev
        roof = audit.roofline_terms(flops=flops, bytes=low.argument_bytes,
                                    wire_bytes=rep.total_wire_bytes)
        record.update({
            "status": "ok",
            "devices": n_dev,
            "build_s": round(t_build, 2),
            "lower_s": round(t_lower, 2),
            "memory": {
                "argument_bytes": low.argument_bytes,
                "argument_bytes_by_group": low.arg_bytes,
                "temp_bytes": None,
                "peak_per_device_gb": None,
                "reason": ("the meta device has no allocator: a step's "
                           "temporaries and peak are not measured"),
            },
            "step": {
                "dot_flops": rep.dot_flops,
                "wire_bytes": rep.total_wire_bytes,
                "collective_bytes_by_kind": rep.by_kind(),
                "n_collectives": len(rep.collectives),
                "launches": low.launches,
            },
            "roofline": {
                "flops_per_device": flops,
                "compute_s": roof.compute_s,
                "memory_s": roof.memory_s,
                "collective_s": roof.collective_s,
                "dominant": roof.dominant,
                "fits_80gb": low.argument_bytes <= audit.HBM_BYTES,
            },
        })
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    _write(path, record)
    return record


def _write(path: str, record: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=2, default=float)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    from repro_torch.configs import SHAPES, list_archs

    archs = args.arch or (list_archs() if args.all else [])
    shapes = args.shape or list(SHAPES)
    if not archs:
        ap.error("pass --arch <id> (repeatable) or --all")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                rec = run_cell(arch, shape, multi, args.out,
                               force=args.force)
                status = rec.get("status")
                extra = ""
                if status == "ok":
                    gb = rec["memory"]["argument_bytes"] / 2**30
                    wire = rec["step"]["wire_bytes"] / 2**30
                    extra = (f" args={gb:.3f}GB lower={rec['lower_s']}s"
                             f" wire={wire:.3f}GB "
                             f"{rec['roofline']['dominant']}")
                elif status == "error":
                    extra = " " + rec["error"][:120]
                print(f"[{status:>7s}] {rec['cell']}{extra}", flush=True)


if __name__ == "__main__":
    main()
