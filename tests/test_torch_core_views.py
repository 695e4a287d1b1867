"""Cases of ``tests/test_torch_core.py`` in a file of at most 8 tests, so
that pytest-xdist's ``loadfile`` scheduler (largest files first) runs
them beside ``tests/test_differential.py`` rather than ahead of it.
Each test keeps its name and case ids; its body is the helper of the
same name without ``test_`` in the source file, which holds the case
lists too.
"""
import pytest

from tests.test_torch_core import (
    context_access_forms_match_reference,
    port_imports_neither_jax_nor_the_reference,
    report_renders_the_reference_plan_view)


def test_context_access_forms_match_reference():
    """``context_access_forms_match_reference`` of
    ``tests/test_torch_core.py``, every case."""
    context_access_forms_match_reference()


def test_report_renders_the_reference_plan_view():
    """``report_renders_the_reference_plan_view`` of
    ``tests/test_torch_core.py``, every case."""
    report_renders_the_reference_plan_view()


def test_port_imports_neither_jax_nor_the_reference():
    """``port_imports_neither_jax_nor_the_reference`` of
    ``tests/test_torch_core.py``, every case."""
    port_imports_neither_jax_nor_the_reference()
