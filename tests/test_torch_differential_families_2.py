"""Cases of ``tests/test_torch_differential.py`` in a file of at most 8
tests, so that pytest-xdist's ``loadfile`` scheduler (largest files
first) runs them beside ``tests/test_differential.py`` rather than ahead
of it.  Each test keeps its name and case ids; its body is the helper of
the same name without ``test_`` in the source file, which holds the case
lists too.
"""
import pytest

from tests.test_torch_differential import (
    EVERY_BLOCK_FAMILY_MATCHES_JAX_REFERENCE_FAMILY,
    EVERY_BLOCK_FAMILY_MATCHES_JAX_REFERENCE_P,
    every_block_family_matches_jax_reference)


@pytest.mark.parametrize("p", EVERY_BLOCK_FAMILY_MATCHES_JAX_REFERENCE_P)
@pytest.mark.parametrize(
    "family", EVERY_BLOCK_FAMILY_MATCHES_JAX_REFERENCE_FAMILY[2:4])
def test_every_block_family_matches_jax_reference(family, p):
    """``every_block_family_matches_jax_reference`` of
    ``tests/test_torch_differential.py``, its ``family`` cases 2 to 3
    (from 0)."""
    every_block_family_matches_jax_reference(family=family, p=p)
