"""Cases of ``tests/test_torch_repairs.py`` in a file of at most 8 tests,
so that pytest-xdist's ``loadfile`` scheduler (largest files first) runs
them beside ``tests/test_differential.py`` rather than ahead of it.
Each test keeps its name and case ids; its body is the helper of the
same name without ``test_`` in the source file, which holds the case
lists too.
"""
import pytest

from tests.test_torch_repairs import (
    FORMER_REFUSALS_MATCH_REFERENCE_BODY,
    FORMER_REFUSALS_MATCH_REFERENCE_CAP, former_refusals_match_reference)


@pytest.mark.parametrize("cap", FORMER_REFUSALS_MATCH_REFERENCE_CAP)
@pytest.mark.parametrize("body", FORMER_REFUSALS_MATCH_REFERENCE_BODY[4:5])
def test_former_refusals_match_reference(body, cap, monkeypatch):
    """``former_refusals_match_reference`` of
    ``tests/test_torch_repairs.py``, its ``body`` cases 4 to 4 (from 0)."""
    former_refusals_match_reference(
        body=body, cap=cap, monkeypatch=monkeypatch)
