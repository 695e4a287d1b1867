"""Cases of ``tests/test_torch_span_kernel.py`` in a file of at most 8
tests, so that pytest-xdist's ``loadfile`` scheduler (largest files
first) runs them beside ``tests/test_differential.py`` rather than ahead
of it.  Each test keeps its name and case ids; its body is the helper of
the same name without ``test_`` in the source file, which holds the case
lists too.
"""
import pytest

from tests.test_torch_span_kernel import (
    generated_kernel_heat2d_halo_windows, generated_product_forms)


def test_generated_product_forms(monkeypatch):
    """``generated_product_forms`` of
    ``tests/test_torch_span_kernel.py``, every case."""
    generated_product_forms(monkeypatch=monkeypatch)


def test_generated_kernel_heat2d_halo_windows():
    """``generated_kernel_heat2d_halo_windows`` of
    ``tests/test_torch_span_kernel.py``, every case."""
    generated_kernel_heat2d_halo_windows()
