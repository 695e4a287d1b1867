"""Cases of ``tests/test_torch_flash_attention.py`` in a file of at most 8
tests, so that pytest-xdist's ``loadfile`` scheduler (largest files
first) runs them beside ``tests/test_differential.py`` rather than ahead
of it.  Each test keeps its name and case ids; its body is the helper of
the same name without ``test_`` in the source file, which holds the case
lists too.
"""
import pytest

from tests.test_torch_flash_attention import (
    PLAIN_AND_OPS_MATCH_JAX_ORACLE_IDX,
    head_dim_padding_is_exact_and_over_256_is_refused,
    plain_and_ops_match_jax_oracle)


@pytest.mark.parametrize("idx", PLAIN_AND_OPS_MATCH_JAX_ORACLE_IDX)
def test_plain_and_ops_match_jax_oracle(idx):
    """``plain_and_ops_match_jax_oracle`` of
    ``tests/test_torch_flash_attention.py``, every case."""
    plain_and_ops_match_jax_oracle(idx=idx)


def test_head_dim_padding_is_exact_and_over_256_is_refused():
    """``head_dim_padding_is_exact_and_over_256_is_refused`` of
    ``tests/test_torch_flash_attention.py``, every case."""
    head_dim_padding_is_exact_and_over_256_is_refused()
