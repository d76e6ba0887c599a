"""Deterministic, checkpointable synthetic token pipeline: a copy of
``repro.data.pipeline`` (numpy only).

Tokens at step ``n`` come from ``numpy.random.default_rng((seed, n))``, so

* the pipeline state is a single integer (``step``) -- trivially
  checkpointable and exactly resumable after a restart,
* replaying a step gives the same batch.

A file-backed reader (`MemmapDataset`) is included for running from a real
tokenized corpus (flat uint16/uint32 binary, memory-mapped).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class PipelineState:
    step: int = 0


class SyntheticLM:
    """Markov-flavored synthetic LM tokens (not uniform noise: the induced
    distribution has learnable bigram structure so loss curves move)."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed

    def _tokens(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        b, s, v = self.batch, self.seq, self.vocab
        base = rng.integers(0, v, size=(b, 1), dtype=np.int32)
        drift = rng.integers(1, 17, size=(b, s), dtype=np.int32)
        toks = (base + np.cumsum(drift, axis=1)) % v
        return toks.astype(np.int32)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        toks = self._tokens(step)
        inputs = toks[:, :-1] if toks.shape[1] > self.seq else toks
        # next-token prediction: labels are inputs shifted left.
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = 0
        return {"tokens": toks, "labels": labels}

    def __call__(self, state: PipelineState) -> tuple[dict, PipelineState]:
        return self.batch_at(state.step), PipelineState(state.step + 1)


class MemmapDataset:
    """Flat binary token file -> [B, S] batches, deterministic per step."""

    def __init__(self, path: str, vocab_size: int, seq_len: int,
                 global_batch: int, dtype=np.uint16):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.n_windows = max(1, (len(self.data) - 1) // seq_len)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(step)
        idx = rng.integers(0, self.n_windows, size=(self.batch,))
        toks = np.stack([
            self.data[i * self.seq: i * self.seq + self.seq] for i in idx
        ]).astype(np.int32) % self.vocab
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = 0
        return {"tokens": toks, "labels": labels}

    def __call__(self, state: PipelineState):
        return self.batch_at(state.step), PipelineState(state.step + 1)
