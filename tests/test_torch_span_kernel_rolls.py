"""Cases of ``tests/test_torch_span_kernel.py`` in a file of at most 8
tests, so that pytest-xdist's ``loadfile`` scheduler (largest files
first) runs them beside ``tests/test_differential.py`` rather than ahead
of it.  Each test keeps its name and case ids; its body is the helper of
the same name without ``test_`` in the source file, which holds the case
lists too.
"""
import pytest

from tests.test_torch_span_kernel import (
    GENERATED_MULTI_STAGE_SPAN_MATCHES_PLAIN_P,
    GENERATED_ROLL_MATCHES_PLAIN_SHIFT,
    GENERATED_ROW_SUM_PRODUCTS_MATCH_PLAIN_DTYPE,
    generated_multi_stage_span_matches_plain, generated_roll_matches_plain,
    generated_row_sum_products_match_plain)


@pytest.mark.parametrize("shift", GENERATED_ROLL_MATCHES_PLAIN_SHIFT)
def test_generated_roll_matches_plain(shift, monkeypatch):
    """``generated_roll_matches_plain`` of
    ``tests/test_torch_span_kernel.py``, every case."""
    generated_roll_matches_plain(shift=shift, monkeypatch=monkeypatch)


@pytest.mark.parametrize("dtype", GENERATED_ROW_SUM_PRODUCTS_MATCH_PLAIN_DTYPE)
def test_generated_row_sum_products_match_plain(dtype, monkeypatch):
    """``generated_row_sum_products_match_plain`` of
    ``tests/test_torch_span_kernel.py``, every case."""
    generated_row_sum_products_match_plain(
        dtype=dtype, monkeypatch=monkeypatch)


@pytest.mark.parametrize("p", GENERATED_MULTI_STAGE_SPAN_MATCHES_PLAIN_P)
def test_generated_multi_stage_span_matches_plain(p, monkeypatch):
    """``generated_multi_stage_span_matches_plain`` of
    ``tests/test_torch_span_kernel.py``, every case."""
    generated_multi_stage_span_matches_plain(p=p, monkeypatch=monkeypatch)
