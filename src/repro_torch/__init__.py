"""repro_torch: OMP2MPI on PyTorch — the port of :mod:`repro` to PyTorch
and CUDA (Hopper).

Public surface::

    from repro_torch import omp     # the compiler pipeline, as in repro.omp

Every entry point runs on the CUDA device unless the caller passes
``device="cpu"`` to :func:`repro_torch.omp.make_mesh`.
"""
__version__ = "0.1.0"
