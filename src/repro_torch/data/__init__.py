"""Deterministic synthetic data pipeline (the training substrate) —
counterpart of :mod:`repro.data`: a learnable token stream (a Zipfian
unigram floor mixed with a seeded first-order Markov chain), drawn
deterministically from (seed, step, shard), so a resumed run sees the
batches the lost one would have.
"""
from repro_torch.data.pipeline import (  # noqa: F401
    SyntheticLM, batch_key, make_batch_iterator)
