"""The port's kernels on the card against their plain PyTorch versions:
the span kernel (K1, Triton) on every block family and on PolyBench's
products, flash attention (K2, CUDA C++) and the SSD scan (K3, CUDA C++)
on their test cases.

Marked ``gpu``: it skips without a CUDA card.  Run it on the machine with
the card (it needs neither JAX nor the reference package)::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch


@pytest.mark.gpu
def test_span_kernel_on_the_card_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    from repro_torch import omp
    from repro_torch.core import kernel_lower, transform
    from repro_torch.kernels import span_kernel

    for prog, env in chip_smoke.families(omp, torch, torch.device("cuda")):
        axes = ("data",) if prog.rank == 1 else ("i", "j")
        mesh = omp.make_mesh((2,) * prog.rank, axes)
        chip_smoke.compare_spans(torch, omp, transform, kernel_lower,
                                 span_kernel, prog, env, mesh, "slice",
                                 f"family {prog.name}")



@pytest.mark.gpu
def test_polybench_products_on_the_card():
    """``chip_smoke.py``'s polybench phase on five kernels at EXTRALARGE
    size (a row-times-matrix, a matrix-vector, a transposed matrix, a
    two-pass centring and jacobi2d's rolled rows): both lowerings ==
    ``run_reference``, K1's launches, each span against its plain version
    (which also rejects TF32 products) and twice against itself."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke

    rows = chip_smoke.polybench_phase(
        torch, torch.device("cuda"), "test",
        ("gemm", "atax", "syrk", "covariance", "jacobi2d"))
    assert [r["launches"] for r in rows] == [1, 3, 1, 2, 1]


@pytest.mark.gpu
def test_flash_attention_kernel_on_the_card_matches_plain():
    """K2 against its plain version on the 7 cases of
    tests/test_kernels.py and gemma3-1b's attention shapes, with
    ``chip_smoke.py``'s check (which also rejects wrong outputs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    from repro_torch.kernels import flash_attention as fa

    for n, case in enumerate(chip_smoke.k2_cases(torch)):
        label, b, h, kv, sq, sk, hd, causal, window, dtype, tol = case
        q, k, v = chip_smoke.k2_inputs(torch, "cuda", b, h, kv, sq, sk, hd,
                                       dtype, n)
        before = fa.LAUNCHES[window]
        chip_smoke.check_k2(torch, fa, q, k, v, causal, window, tol,
                            f"{label} {dtype}")
        assert fa.LAUNCHES[window] == before + 1


@pytest.mark.gpu
def test_conversion_helpers_default_to_the_card():
    """``params_from_numpy`` / ``cache_from_numpy`` with no device put
    their leaves on the CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from repro_torch import convert

    tree = {"blk": {"w": np.ones((2, 3), np.float32)}}
    for fn in (convert.params_from_numpy, convert.cache_from_numpy):
        assert fn(tree)["blk"]["w"].device.type == "cuda"


@pytest.mark.gpu
def test_ssd_scan_kernel_on_the_card_matches_plain():
    """K3 against its plain version on the 5 cases of tests/test_kernels.py,
    with ``chip_smoke.py``'s check (which also rejects wrong outputs); the
    counter moves once per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    from repro_torch.kernels import ssd_scan as ssd

    for n, case in enumerate(chip_smoke.k3_cases(torch)[:5]):
        label, b, s, h, p, nst, chunk, dtype = case
        args = chip_smoke.k3_inputs(torch, "cuda", b, s, h, p, nst, dtype, n)
        chip_smoke.check_k3(torch, ssd, args, chunk,
                            chip_smoke.K3_TOL[chip_smoke.dtname(dtype)],
                            f"{label} {dtype}")


@pytest.mark.gpu
def test_ssd_scan_kernel_chunk_over_256_matches_plain():
    """A chunk over K3's 256 runs as 256 and equals the plain version,
    in float32 and bfloat16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    from repro_torch.kernels import ssd_scan as ssd

    for n, case in enumerate(chip_smoke.k3_long_chunk_cases(torch)):
        label, b, s, h, p, nst, chunk, dtype = case
        assert chunk > ssd.MAX_CHUNK
        args = chip_smoke.k3_inputs(torch, "cuda", b, s, h, p, nst, dtype, n)
        chip_smoke.check_k3(torch, ssd, args, chunk,
                            chip_smoke.K3_TOL[chip_smoke.dtname(dtype)],
                            f"{label} {dtype}")


@pytest.mark.gpu
def test_region_spans_on_the_card_match_plain():
    """Small region programs (one 3-stage span, halo-fed spans, a 2-D
    mesh, serial glue) under the kernel lowering on the card: outputs
    equal the shared-memory run, K1 launches once per span per run, and
    every span equals its multi-stage plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    from repro_torch import omp
    from repro_torch.core import kernel_lower
    from repro_torch.kernels import span_kernel

    dev = torch.device("cuda")
    for make, args in ((chip_smoke.jacobi_chain_region, (4099,)),
                       (chip_smoke.heat3_region, (4099, 64)),
                       (chip_smoke.heat2d_region, (70, 8)),
                       (chip_smoke.pipeline_region, (3001,))):
        reg, env, shape, axes = make(omp, torch, dev, *args)
        comp = omp.compile(reg, omp.make_mesh(shape, axes), lowering="kernel")
        ref = reg(env)
        comp(env)
        span_kernel.LAUNCHES = 0
        out = comp(env)
        torch.cuda.synchronize()
        assert span_kernel.LAUNCHES == comp.kernel_plan.n_kernels > 0
        for k in ref:
            torch.testing.assert_close(out[k], ref[k], rtol=1e-4, atol=1e-4)
        chip_smoke.check_region_spans(torch, kernel_lower, span_kernel,
                                      comp, env, dev, reg.name)


@pytest.mark.gpu
def test_span_launcher_equals_triton_launch_bit_for_bit():
    """K1's launcher (one C call into the compiled kernel, outputs in one
    allocation) against Triton's own launch path on the same feeds, every
    block family and a short PolyBench span: equal bit for bit on the
    lanes that hold an iteration; a window view off 16 bytes compiles a
    second specialisation and still equals Triton's path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    from repro_torch import omp
    from repro_torch.core import kernel_lower, transform
    from repro_torch.kernels import span_kernel

    dev = torch.device("cuda")
    for prog, env in chip_smoke.families(omp, torch, dev):
        axes = ("data",) if prog.rank == 1 else ("i", "j")
        comp = omp.compile(prog, omp.make_mesh((2,) * prog.rank, axes),
                           lowering="kernel", shard="slice", env_like=env)
        repl, slabs = transform.stage_inputs(comp.plan, env)
        one = chip_smoke.one_stage(kernel_lower, comp.plan, prog, slabs,
                                   repl)
        for span in comp.kernel_plan.spans:
            assert chip_smoke.hold_launch_bits(
                torch, kernel_lower, span_kernel, span.source, one, dev,
                prog.name) > 0
    (prog, env), = [(p, e) for p, e in chip_smoke.families(omp, torch, dev)
                    if p.name == "map"] or [chip_smoke.families(
                        omp, torch, dev)[0]]
    comp = omp.compile(prog, omp.make_mesh((2,), ("data",)),
                       lowering="kernel", env_like=env)
    source = comp.kernel_plan.spans[0].source
    repl, slabs = transform.stage_inputs(comp.plan, env)
    shifted = {k: torch.cat([v.new_zeros(1), v.reshape(-1)])[1:].view(
        v.shape) for k, v in {**repl, **slabs}.items()}
    one = chip_smoke.one_stage(
        kernel_lower, comp.plan, prog,
        {k: shifted[k] for k in slabs}, {k: shifted[k] for k in repl})
    chip_smoke.hold_launch_bits(torch, kernel_lower, span_kernel, source,
                                one, dev, f"{prog.name} shifted")


@pytest.mark.gpu
def test_flash_attention_past_head_dim_256_matches_plain():
    """K2 at head_dim 288 and 512 (the wide kernel) against its plain
    version, bfloat16 and float32, causal with and without a window,
    with ``chip_smoke.py``'s checks; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    from repro_torch.kernels import flash_attention as fa

    tols = {torch.bfloat16: 1e-2, torch.float32: 2e-5}
    for hd in (288, 512):
        for dtype, tol in tols.items():
            for window in (None, 64):
                q, k, v = chip_smoke.k2_inputs(torch, "cuda", 1, 4, 2, 300,
                                               300, hd, dtype, hd)
                before = fa.LAUNCHES[window]
                chip_smoke.check_k2(torch, fa, q, k, v, True, window, tol,
                                    f"hd{hd} {dtype} window={window}")
                assert fa.LAUNCHES[window] == before + 1


@pytest.mark.gpu
def test_ssd_scan_kernel_16bit_small_cases_match_plain():
    """K3's tensor-core products in 16 bits (m16n8k16, float32 operands
    as hi + lo halves) on the 5 small cases of tests/test_kernels.py
    taken to bfloat16 and float16, with ``chip_smoke.py``'s checks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    from repro_torch.kernels import ssd_scan as ssd

    for n, case in enumerate(chip_smoke.k3_cases(torch)[:5]):
        label, b, s, h, p, nst, chunk, _ = case
        for dtype in (torch.bfloat16, torch.float16):
            args = chip_smoke.k3_inputs(torch, "cuda", b, s, h, p, nst,
                                        dtype, n)
            chip_smoke.check_k3(torch, ssd, args, chunk,
                                chip_smoke.K3_TOL[chip_smoke.dtname(dtype)],
                                f"{label} {dtype}")
