#!/usr/bin/env python3
"""Show that the region-span check catches a forward served from the
neighbouring lane's tile.

    python3 tools/k1_planted_fault.py

Compiles ``chip_smoke.py``'s ``jacobi_chain`` and ``pipeline`` regions
(N = 2^24, 8 ranks) with ``lowering="kernel"`` and records the spans of
one run on the programs' own data and one on the seeded normal data that
``chip_smoke.check_region_spans`` feeds.  For each span that forwards a
key, a mutant of its generated Triton source (written, imported and
built in a temporary directory, never in the checkout) plants one fault:
once the producing stage has stored the key, the stages after it read
the value the NEXT lane stored instead of their own register tile (a
tile's last lane keeps its own).  Prints, per program and data, whether
phase 4's whole-tensor ``agree`` and ``chip_smoke.hold_lanes`` (with its
rejection of a one-lane move) accept the unmutated kernel and the
mutant.  Exits 0 when, on the seeded normal data, the unmutated kernel
passes and the mutant fails in both programs; needs one CUDA card.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os
import re
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def plant(source, tmp: Path):
    """The mutant of ``source``: its first forwarded key served from the
    next lane's stored value; built from ``tmp``."""
    text = source.text
    tile = int(re.search(r"lane = tile \* (\d+) \+ tl\.arange", text)[1])
    c = int(re.search(r"lmask = lane < (\d+)\n", text)[1])
    stage, key = source.forwarded[0]
    i = max(i for i, (si, k, _, _) in enumerate(source.outputs)
            if k == key and si < stage)
    si = source.outputs[i][0]
    store = re.search(rf"    tl\.store\((o{si}_{i}) \+ (\(slot \* {c} \+ "
                      rf"lane\)), (v\d+), mask=lmask\)\n", text)
    if store is None:
        raise SystemExit(f"k1_planted_fault: no scalar store of {key!r} in "
                         f"{source.fn_name}")
    ptr, base, var = store.groups()
    nb = f"(lane + 1 < {c}) & ((lane + 1) % {tile} != 0)"
    fault = (f"    tl.debug_barrier()\n"
             f"    {var} = tl.where({nb}, tl.load({ptr} + {base} + 1, "
             f"mask=lmask & {nb}), {var})\n")
    name = source.fn_name + "_fault"
    text = (text[:store.end()] + fault + text[store.end():]).replace(
        f"def {source.fn_name}(", f"def {name}(")
    path = tmp / f"{name}.py"
    path.write_text(text)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    from repro_torch.kernels import span_kernel

    span_kernel._KERNELS[name] = getattr(module, name)
    return dataclasses.replace(source, fn_name=name, text=text), key


def verdicts(cs, torch, kernel_lower, span_kernel, source, stages, dev):
    """(whole-tensor agree passes, hold_lanes passes) for ``source``'s
    kernel on ``stages``' feeds."""
    got = span_kernel.launch_span(
        source, [(st.ext_windows, st.env_repl) for st in stages], dev)
    want = span_kernel.span_values_plain_stages(stages, dev)
    whole = lanes = True
    for st, g, w in zip(stages, got, want):
        mask = kernel_lower.lane_mask(st.plan, dev)
        tol = cs.span_tol(source)
        whole &= all(cs.agree(torch, g[k][mask], w[k][mask], tol) for k in w)
        try:
            cs.hold_lanes(torch, g, w, mask, tol, "check",
                          lane_dim=3 * st.plan.rank - 1)
        except AssertionError as exc:
            lanes = False
            print(f"    hold_lanes: {exc}")
    return whole, lanes


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    torch = cs._setup()
    ok, planted = True, 0
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["TRITON_CACHE_DIR"] = str(Path(tmp) / "triton")
        from repro_torch import omp
        from repro_torch.core import kernel_lower
        from repro_torch.kernels import span_kernel

        dev = torch.device("cuda")
        print(f"card: {cs.card_line()}")
        for make in (cs.jacobi_chain_region, cs.pipeline_region):
            reg, env, shape, axes = make(omp, torch, dev)
            comp = omp.compile(reg, omp.make_mesh(shape, axes, device=dev),
                               lowering="kernel", env_like=env)
            for data, feed in (("own data", env),
                               ("seeded normal data",
                                cs.random_env(torch, env, 0))):
                calls = cs.record_spans(span_kernel, lambda: comp(feed))
                for stages, source in calls:
                    if not source.forwarded:
                        continue
                    mutant, key = plant(source, Path(tmp))
                    planted += data != "own data"
                    span = "+".join(st.plan.name for st in stages)
                    for label, src in (
                            ("kernel", source),
                            (f"mutant ({key!r} from the next lane)", mutant)):
                        whole, lanes = verdicts(cs, torch, kernel_lower,
                                                span_kernel, src, stages, dev)
                        print(f"{reg.name} span {span}, {data}, {label}: "
                              f"agree {'passes' if whole else 'fails'}, "
                              f"hold_lanes {'passes' if lanes else 'fails'}")
                        if data != "own data":
                            ok &= lanes == (src is source)
                torch.cuda.synchronize()
            del comp, env
            torch.cuda.empty_cache()
    return 0 if ok and planted == 2 else 1


if __name__ == "__main__":
    raise SystemExit(main())
