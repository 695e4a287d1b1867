"""The port's kernels on the card against their plain PyTorch versions:
the span kernel (K1, Triton) on every block family, flash attention
(K2, CUDA C++) and the SSD scan (K3, CUDA C++) on their test cases.

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
