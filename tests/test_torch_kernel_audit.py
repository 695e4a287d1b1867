"""An audit of K1's coverage on the CPU: every torch-bodied program the
port already has, compiled under ``lowering="kernel"`` (the span kernel
is generated from each body's aten graph; nothing runs).

The programs: the block and region families of
``tests/test_torch_differential.py`` and ``tests/test_torch_region.py``
(one seed each, and the region tests' extra programs), the twelve
PolyBench kernels of :mod:`repro_torch.polybench` at small dims, and
the bodies of ``tests/test_torch_repairs.py``.  The set of programs the
kernel lowering refuses, and the op each refusal names, must equal
:data:`REFUSED`, the list that ``ROADMAP.md`` §3 item 4 records: a new
refusal, or a refusal closed, shows here first.
"""
import re

import numpy as np
import pytest
import torch

from tests import test_torch_differential as td
from tests import test_torch_polybench as tpb
from tests import test_torch_region as tr
from tests import test_torch_repairs as trp

#: Program name -> the op (or reason) its kernel-lowering refusal names.
REFUSED = {
    "hostglue_region": "a stage is not shape-traceable",
}


def _programs():
    """(name, program, env) of every torch-bodied program of the port."""
    from repro_torch import convert, omp
    from repro_torch.polybench import make

    out = []
    for j, fam in enumerate(td.BLOCK_FAMILIES):
        prog, env = td.make_case(700 + j, fam)[:2]
        out.append((prog.name, prog, env))
    for j, fam in enumerate(td.BLOCK_FAMILIES2):
        prog, env = td.make_case2(720 + j, fam)[:2]
        out.append((prog.name, prog, env))
    for j, fam in enumerate(tr.FAMILIES):
        prog, env = tr.make_case(740 + j, fam)[:2]
        out.append((prog.name, prog, env))
    for j, fam in enumerate(tr.FAMILIES2):
        prog, env = tr.make_case2(760 + j, fam)[:2]
        out.append((prog.name, prog, env))
    regions = tr._more_regions(omp, torch) + [
        tr._chain(omp, torch), tr._host_glue_region(omp, torch),
        tr._multifield(omp, lib=torch)]
    for prog, env_np in regions:
        out.append((prog.name, prog, convert.env_from_numpy(env_np, "cpu")))
    for name, dims in tpb.DIMS.items():
        pk = make(name, dims)
        env = pk.env_fn("cpu")
        for prog in pk.programs:
            out.append((f"{name}/{prog.name}", prog, env))
    repairs = [
        (trp._cumsum_bodies, trp._cumsum_envs),
        (lambda o, lib: [trp._rolled_scan_body(o, lib)],
         lambda: [trp._rolled_scan_env()]),
        (trp._lane_roll_bodies, trp._lane_roll_envs),
        (trp._forward_roll_regions,
         lambda: [trp._forward_roll_env()] * 2),
    ]
    singles = [(trp._math_body, trp._math_env), (trp._nan_body, trp._nan_env),
               (trp._cumprod_body, trp._cumprod_env),
               (trp._gather_body, trp._gather_env),
               (trp._sort_body, trp._sort_env),
               (trp._handoff_region, trp._handoff_env),
               (trp._assoc_scan_body, trp._assoc_scan_env),
               (trp._argsort_body, trp._argsort_env),
               (trp._int_pow_body, trp._int_pow_env),
               (trp._one_column_body, trp._one_column_env)]
    repairs += [(lambda o, lib, b=b: [b(o, lib)], lambda e=e: [e()])
                for b, e in singles]
    repairs.append((trp._int_product_bodies,
                    lambda: [trp._int_product_env()] * 2))
    for bodies, envs in repairs:
        for prog, env_np in zip(bodies(omp, torch), envs()):
            out.append((prog.name, prog,
                        convert.env_from_numpy(env_np, "cpu")))
    return out


def _refusal(prog, env, mesh) -> str | None:
    from repro_torch import omp

    try:
        omp.compile(prog, mesh[prog.rank], lowering="kernel", env_like=env)
    except omp.CompileError as e:
        msg = str(e)
        named = re.search(r"aten op (\S+)|(aten\.\w+)|(a stage is not "
                          r"shape-traceable)", msg)
        return next(g for g in named.groups() if g) if named else msg
    return None


def test_kernel_lowering_refuses_exactly_the_recorded_programs():
    from repro_torch import omp

    omp.clear_compile_cache()
    mesh = {1: omp.make_mesh((2,), ("data",), device="cpu"),
            2: omp.make_mesh((2, 1), ("i", "j"), device="cpu")}
    progs = _programs()
    assert len(progs) >= 60, len(progs)
    refused = {}
    for name, prog, env in progs:
        got = _refusal(prog, env, mesh)
        if got is not None:
            refused[name] = got
    omp.clear_compile_cache()
    assert refused == REFUSED
