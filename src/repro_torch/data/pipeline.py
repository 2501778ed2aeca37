"""Deterministic synthetic token pipeline: a copy of
``repro.data.pipeline`` (NumPy only, so the batches are the same bits as
the reference's; the port keeps its own copy because it imports nothing of
``repro``). The train driver moves each batch to its device.

Generates reproducible token streams (a fixed-seed Zipfian-ish mixture so
losses are learnable, not uniform noise), sharded by host: each host
materializes only its slice of the global batch — the pattern a real
multi-host input pipeline (e.g. grain/tf.data) uses at scale. Restart-safe:
the stream is a pure function of (seed, step), so resuming from a
checkpoint at step k regenerates exactly the batches k, k+1, ...
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SyntheticTokens:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.n_hosts} hosts")
        return self.global_batch // self.n_hosts

    def batch_at(self, step: int) -> dict:
        """{'tokens': (host_batch, seq), 'labels': (host_batch, seq)} for
        this host at `step` — pure function of (seed, step, host_id)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        b, s = self.host_batch, self.seq_len
        # Zipf-like marginal over a smallish head + uniform tail, plus a
        # copy structure (next token repeats prev with p=0.3) so a model
        # can actually reduce loss.
        head = min(self.vocab, 1024)
        p = 1.0 / np.arange(1, head + 1)
        p /= p.sum()
        base = rng.choice(head, size=(b, s), p=p).astype(np.int32)
        shift = np.roll(base, 1, axis=1)
        copy_mask = rng.random((b, s)) < 0.3
        tokens = np.where(copy_mask, shift, base).astype(np.int32)
        labels = np.roll(tokens, -1, axis=1).astype(np.int32)
        return {"tokens": tokens, "labels": labels}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_pipeline(vocab: int, seq_len: int, global_batch: int, seed: int = 0,
                  n_hosts: int = 1, host_id: int = 0) -> SyntheticTokens:
    return SyntheticTokens(vocab, seq_len, global_batch, seed, n_hosts,
                           host_id)
