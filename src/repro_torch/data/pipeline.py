"""Synthetic LM data: seeded Zipf + Markov mixture, shard-deterministic.

The transition matrix and the unigram come from
``np.random.default_rng(seed)`` as in the reference, so they are the
reference's.  The draws (the chain's states, the band offsets, the Zipf
noise, the mix, embeddings and frames) come from a ``torch.Generator``
seeded from (seed, step, shard): the same distribution, not
``jax.random``'s bits.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticLM:
    """Deterministic synthetic token distribution.

    A first-order Markov chain over a reduced state space (``n_states``)
    lifted to the full vocab; transition structure is fixed by ``seed``.
    """

    vocab_size: int
    seed: int = 0
    n_states: int = 64
    markov_weight: float = 0.7

    def __post_init__(self) -> None:
        rng = np.random.default_rng(self.seed)
        s = self.n_states
        # sparse-ish row-stochastic transition matrix
        logits = rng.normal(size=(s, s)) * 2.0
        keep = rng.random((s, s)) < 0.25
        logits = np.where(keep, logits, -1e9)
        logits[:, 0] = 0.0  # ensure rows are connected
        self._trans = torch.softmax(
            torch.from_numpy(logits.astype(np.float32)), dim=-1)
        # Zipfian unigram over the full vocab
        ranks = np.arange(1, self.vocab_size + 1)
        z = 1.0 / ranks ** 1.1
        self._unigram = torch.from_numpy((z / z.sum()).astype(np.float32))
        # state -> vocab band mapping
        self._band = self.vocab_size // s

    def sample(self, gen: torch.Generator, batch: int,
               seq_len: int) -> torch.Tensor:
        """(batch, seq_len) int32 tokens, on the CPU."""
        band = max(1, self._band)
        state = torch.randint(0, self.n_states, (batch,), generator=gen)
        probs = self._trans + 1e-9
        states = []
        for _ in range(seq_len):
            state = torch.multinomial(probs[state], 1, generator=gen)[:, 0]
            states.append(state)
        states = torch.stack(states, dim=1)               # (B, S)
        # lift: mostly a deterministic token inside the state's band,
        # mixed with Zipf noise
        offs = torch.randint(0, band, (batch, seq_len), generator=gen)
        markov_tok = states * self._band + offs % band
        zipf_tok = torch.multinomial(self._unigram + 1e-12, batch * seq_len,
                                     replacement=True,
                                     generator=gen).view(batch, seq_len)
        pick = torch.rand((batch, seq_len), generator=gen) \
            < self.markov_weight
        return (torch.where(pick, markov_tok, zipf_tok)
                % self.vocab_size).to(torch.int32)


def batch_key(seed: int, step: int, shard: int, *more: int
              ) -> torch.Generator:
    """A CPU generator seeded from (seed, step, shard[, more]) — the
    counterpart of the reference's ``fold_in`` chain of keys."""
    state = np.random.SeedSequence([seed, step, shard, *more]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def make_batch_iterator(
    *,
    vocab_size: int,
    batch: int,
    seq_len: int,
    seed: int = 0,
    shard: int = 0,
    num_shards: int = 1,
    start_step: int = 0,
    embed_dim: int | None = None,
    frames: int | None = None,
) -> Iterator[dict]:
    """Yields batches for this host shard, deterministically per step
    (CPU tensors).

    ``embed_dim`` switches to precomputed-embedding batches (VLM stub);
    ``frames`` adds encoder frames (whisper stub; needs ``embed_dim``).
    """
    assert batch % num_shards == 0, (batch, num_shards)
    if frames is not None and embed_dim is None:
        raise ValueError("frames requires embed_dim for the stub")
    local = batch // num_shards
    dist = SyntheticLM(vocab_size, seed=seed)
    step = start_step
    while True:
        tokens = dist.sample(batch_key(seed, step, shard), local, seq_len)
        out = {"labels": tokens}
        if frames is not None:
            out["frames"] = torch.randn(
                (local, frames, embed_dim),
                generator=batch_key(seed, step, shard, 2)) * 0.1
            out["tokens"] = tokens
        elif embed_dim is not None:
            out["embeds"] = torch.randn(
                (local, seq_len, embed_dim),
                generator=batch_key(seed, step, shard, 1)) * 0.1
        else:
            out["tokens"] = tokens
        yield out
        step += 1
