"""The span kernel (K1) on the card: real Triton launches against the
plain PyTorch version, every block family.

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
