"""Cases of ``tests/test_torch_span_kernel.py`` in a file of at most 8
tests, so that pytest-xdist's ``loadfile`` scheduler (largest files
first) runs them beside ``tests/test_differential.py`` rather than ahead
of it.  Each test keeps its name and case ids; its body is the helper of
the same name without ``test_`` in the source file, which holds the case
lists too.
"""
import pytest

from tests.test_torch_span_kernel import (
    GENERATED_KERNEL_MATCHES_PLAIN_RANK2_FAMILY,
    GENERATED_KERNEL_MATCHES_PLAIN_RANK2_SHAPE,
    GENERATED_KERNEL_MATCHES_PLAIN_RANK2_SHARD,
    generated_kernel_matches_plain_rank2)


@pytest.mark.parametrize("family", GENERATED_KERNEL_MATCHES_PLAIN_RANK2_FAMILY)
@pytest.mark.parametrize("shape", GENERATED_KERNEL_MATCHES_PLAIN_RANK2_SHAPE)
@pytest.mark.parametrize("shard", GENERATED_KERNEL_MATCHES_PLAIN_RANK2_SHARD)
def test_generated_kernel_matches_plain_rank2(family, shape, shard):
    """``generated_kernel_matches_plain_rank2`` of
    ``tests/test_torch_span_kernel.py``, every case."""
    generated_kernel_matches_plain_rank2(
        family=family, shape=shape, shard=shard)
