"""Synthetic deterministic data pipeline with per-rank sharding + prefetch.

The port's copy of ``repro/data/pipeline.py``, unchanged: numpy batches
(the train step moves them to its device), bit-equal to the reference's.

Deterministic: batch contents are a pure function of (seed, step, rank), so
a restarted/resharded job replays the exact stream — the property the
fault-tolerance tests assert.  A background thread keeps ``prefetch`` batches
ahead of the consumer (host-side overlap with device compute).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np


class SyntheticLM:
    """Token stream: hash-mixed counter -> vocab ids; labels = next token."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, rank: int = 0, world: int = 1,
                 extra_specs: Optional[Dict[str, Any]] = None):
        if global_batch % world:
            raise ValueError(f"global batch {global_batch} not divisible by "
                             f"world {world}")
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // world
        self.seed, self.rank, self.world = seed, rank, world
        self.extra_specs = extra_specs or {}

    def _tokens(self, step: int) -> np.ndarray:
        """Learnable-but-deterministic stream: the first token of each row is
        a hash of (seed, step, rank, row); the rest follow a fixed affine
        bigram map t' = (a*t + c) mod V, so a model can drive the LM loss
        toward zero while restarts replay the exact bytes."""
        base = (np.uint64(self.seed) * np.uint64(0x9E3779B97F4A7C15)
                + np.uint64(step) * np.uint64(0xBF58476D1CE4E5B9))
        idx = (np.arange(self.local_batch, dtype=np.uint64)
               + np.uint64(self.rank * self.local_batch))
        x = idx + base
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
        first = (x % np.uint64(self.vocab)).astype(np.int64)
        toks = np.empty((self.local_batch, self.seq + 1), np.int64)
        toks[:, 0] = first
        a, c = 31, 7
        for j in range(1, self.seq + 1):
            toks[:, j] = (a * toks[:, j - 1] + c) % self.vocab
        return toks.astype(np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        t = self._tokens(step)
        out = {"tokens": t[:, :-1], "labels": t[:, 1:]}
        rng = np.random.default_rng(self.seed * 1000003 + step)
        for name, sds in self.extra_specs.items():
            shape = (self.local_batch,) + tuple(sds.shape[1:])
            out[name] = rng.standard_normal(shape).astype("float32")
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of a batch iterator (host/compute overlap)."""

    _SENTINEL = object()

    def __init__(self, it: Iterator, prefetch: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()

        def worker():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    self._q.put(item)
            except BaseException as e:  # surfaced on next()
                self._err = e
            finally:
                self._q.put(self._SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
