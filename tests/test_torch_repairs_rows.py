"""Cases of ``tests/test_torch_repairs.py`` in a file of at most 8 tests,
so that pytest-xdist's ``loadfile`` scheduler (largest files first) runs
them beside ``tests/test_differential.py`` rather than ahead of it.
Each test keeps its name and case ids; its body is the helper of the
same name without ``test_`` in the source file, which holds the case
lists too.
"""
import pytest

from tests.test_torch_repairs import (
    CUMSUM_ALONG_A_ROW_MATCHES_REFERENCE_RANK,
    ROLL_OF_A_FORWARDED_REGISTER_TILE_MATCHES_REFERENCE_P,
    ROLL_OF_A_SCAN_MATCHES_REFERENCE_CAP,
    ROW_HANDED_OVER_TILE_BY_TILE_MATCHES_REFERENCE_P,
    cumsum_along_a_row_matches_reference,
    roll_of_a_forwarded_register_tile_matches_reference,
    roll_of_a_scan_matches_reference,
    row_handed_over_tile_by_tile_matches_reference)


@pytest.mark.parametrize("rank", CUMSUM_ALONG_A_ROW_MATCHES_REFERENCE_RANK)
def test_cumsum_along_a_row_matches_reference(rank, monkeypatch):
    """``cumsum_along_a_row_matches_reference`` of
    ``tests/test_torch_repairs.py``, every case."""
    cumsum_along_a_row_matches_reference(rank=rank, monkeypatch=monkeypatch)


@pytest.mark.parametrize("cap", ROLL_OF_A_SCAN_MATCHES_REFERENCE_CAP)
def test_roll_of_a_scan_matches_reference(cap, monkeypatch):
    """``roll_of_a_scan_matches_reference`` of
    ``tests/test_torch_repairs.py``, every case."""
    roll_of_a_scan_matches_reference(cap=cap, monkeypatch=monkeypatch)


@pytest.mark.parametrize(
    "p", ROLL_OF_A_FORWARDED_REGISTER_TILE_MATCHES_REFERENCE_P)
def test_roll_of_a_forwarded_register_tile_matches_reference(p, monkeypatch):
    """``roll_of_a_forwarded_register_tile_matches_reference`` of
    ``tests/test_torch_repairs.py``, every case."""
    roll_of_a_forwarded_register_tile_matches_reference(
        p=p, monkeypatch=monkeypatch)


@pytest.mark.parametrize("p", ROW_HANDED_OVER_TILE_BY_TILE_MATCHES_REFERENCE_P)
def test_row_handed_over_tile_by_tile_matches_reference(p, monkeypatch):
    """``row_handed_over_tile_by_tile_matches_reference`` of
    ``tests/test_torch_repairs.py``, every case."""
    row_handed_over_tile_by_tile_matches_reference(
        p=p, monkeypatch=monkeypatch)
