"""Cases of ``tests/test_torch_span_kernel.py`` in a file of at most 8
tests, so that pytest-xdist's ``loadfile`` scheduler (largest files
first) runs them beside ``tests/test_differential.py`` rather than ahead
of it.  Each test keeps its name and case ids; its body is the helper of
the same name without ``test_`` in the source file, which holds the case
lists too.
"""
import pytest

from tests.test_torch_span_kernel import (
    GENERATED_KERNEL_WITH_64BIT_OFFSETS_FAMILY,
    GENERATED_REGION_FAMILY_SPANS_MATCH_PLAIN_FAMILY,
    generated_kernel_with_64bit_offsets,
    generated_region_family_spans_match_plain)


@pytest.mark.parametrize(
    "family", GENERATED_REGION_FAMILY_SPANS_MATCH_PLAIN_FAMILY)
def test_generated_region_family_spans_match_plain(family, monkeypatch):
    """``generated_region_family_spans_match_plain`` of
    ``tests/test_torch_span_kernel.py``, every case."""
    generated_region_family_spans_match_plain(
        family=family, monkeypatch=monkeypatch)


@pytest.mark.parametrize("family", GENERATED_KERNEL_WITH_64BIT_OFFSETS_FAMILY)
def test_generated_kernel_with_64bit_offsets(family, monkeypatch):
    """``generated_kernel_with_64bit_offsets`` of
    ``tests/test_torch_span_kernel.py``, every case."""
    generated_kernel_with_64bit_offsets(family=family, monkeypatch=monkeypatch)
