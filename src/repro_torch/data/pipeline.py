"""Deterministic synthetic token pipeline with host-side prefetch
(``repro.data.pipeline``).

Documents come from a seeded order-1 process (the next token correlated
with the current one), packed into fixed-length sequences with next-token
labels; a background thread prepares step N+1's batch while step N runs.
The batches are numpy arrays, equal to the reference's bit for bit for the
same seed: the caller moves them to its device.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class SyntheticTokenPipeline:
    """``next()`` returns ``{"tokens", "labels"}``, int32 ``(batch, seq_len)``
    (``(batch, seq_len, n_codebooks)`` for a codebook model), batch ``k``
    drawn from ``RandomState(seed * 1_000_003 + k)``.  ``close()`` stops the
    producer thread."""

    def __init__(self, vocab_size: int, seq_len: int, batch: int, *, seed: int = 0,
                 n_codebooks: int = 1, prefetch: int = 2):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = batch
        self.n_codebooks = n_codebooks
        self.seed = seed
        self._step = 0
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _gen(self, step: int) -> dict:
        rng = np.random.RandomState(self.seed * 1_000_003 + step)
        shape = (self.batch, self.seq + 1)
        if self.n_codebooks > 1:
            shape = shape + (self.n_codebooks,)
        base = rng.randint(0, self.vocab, shape)
        drift = rng.randint(0, 17, shape)
        toks = (base + np.cumsum(drift, axis=1)) % self.vocab
        return {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}

    def _producer(self):
        step = 0
        while not self._stop.is_set():
            batch = self._gen(step)
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> dict:
        self._step += 1
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
