"""Cases of ``tests/test_torch_span_kernel.py`` in a file of at most 8
tests, so that pytest-xdist's ``loadfile`` scheduler (largest files
first) runs them beside ``tests/test_differential.py`` rather than ahead
of it.  Each test keeps its name and case ids; its body is the helper of
the same name without ``test_`` in the source file, which holds the case
lists too.
"""
import pytest

from tests.test_torch_span_kernel import (
    GENERATED_KERNEL_MATCHES_PLAIN_RANK1_FAMILY,
    GENERATED_KERNEL_MATCHES_PLAIN_RANK1_P,
    GENERATED_KERNEL_MATCHES_PLAIN_RANK1_SHARD,
    generated_kernel_matches_plain_rank1)


@pytest.mark.parametrize(
    "family", GENERATED_KERNEL_MATCHES_PLAIN_RANK1_FAMILY[0:2])
@pytest.mark.parametrize("p", GENERATED_KERNEL_MATCHES_PLAIN_RANK1_P)
@pytest.mark.parametrize("shard", GENERATED_KERNEL_MATCHES_PLAIN_RANK1_SHARD)
def test_generated_kernel_matches_plain_rank1(family, p, shard):
    """``generated_kernel_matches_plain_rank1`` of
    ``tests/test_torch_span_kernel.py``, its ``family`` cases 0 to 1
    (from 0)."""
    generated_kernel_matches_plain_rank1(family=family, p=p, shard=shard)
