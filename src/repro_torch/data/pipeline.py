"""Data pipeline, as ``repro/data/pipeline.py`` (NumPy only, the same
batches bit for bit): deterministic, seekable, shardable - the properties that
make checkpoint/restart exact.

``SyntheticLM`` generates reproducible token streams from a counter-based
hash (any (step, rank) batch is recomputable, so restoring a checkpoint at
step N resumes the *exact* stream with zero state files).  ``TextFileLM``
byte-tokenizes a file into the same interface.  Each data-parallel rank
reads only its slice; a background prefetch thread keeps one batch ahead
(the host-side analogue of the paper's async kernel launches).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class SyntheticLM:
    """Deterministic synthetic LM tokens with a Zipf-ish marginal."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 *, num_codebooks: int = 1, seed: int = 0,
                 rank: int = 0, world: int = 1):
        assert global_batch % world == 0
        self.vocab, self.seq = vocab_size, seq_len
        self.local_batch = global_batch // world
        self.K = num_codebooks
        self.seed, self.rank, self.world = seed, rank, world

    def state(self, step: int) -> dict:
        return {"step": step, "seed": self.seed, "rank": self.rank}

    def batch_at(self, step: int) -> dict:
        """Recompute the batch for ``step`` - the seekability contract."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.rank)
        shape = (self.local_batch, self.seq, self.K) if self.K > 1 else \
            (self.local_batch, self.seq)
        z = rng.zipf(1.3, size=shape)
        return {"tokens": np.minimum(z, self.vocab - 1).astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class TextFileLM(SyntheticLM):
    """Byte-level tokens from a text file, strided per rank, seekable."""

    def __init__(self, path: str, seq_len: int, global_batch: int,
                 *, rank: int = 0, world: int = 1):
        super().__init__(256, seq_len, global_batch, rank=rank, world=world)
        with open(path, "rb") as f:
            self.data = np.frombuffer(f.read(), np.uint8)

    def batch_at(self, step: int) -> dict:
        n = self.data.shape[0] - self.seq - 1
        rng = np.random.default_rng(step * 65_537 + self.rank)
        starts = rng.integers(0, n, self.local_batch)
        toks = np.stack([self.data[s: s + self.seq] for s in starts])
        return {"tokens": toks.astype(np.int32)}


class Prefetcher:
    """One-batch-ahead background prefetch (resumable from any step)."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.step = start_step
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        s = self.step
        while not self._stop.is_set():
            try:
                self.q.put((s, self.source.batch_at(s)), timeout=0.2)
                s += 1
            except queue.Full:
                continue

    def next(self) -> tuple[int, dict]:
        return self.q.get()

    def close(self):
        self._stop.set()
        self._t.join(timeout=2)
