"""Token data pipeline: deterministic synthetic corpus, packing, prefetch.

No network access, so the corpus is a seeded Zipf stream (heavy-tailed like
natural text) — deterministic per (seed, step), which makes restarts exact:
the loader is stateless given the step counter, the strongest checkpoint
guarantee a pipeline can offer (nothing to snapshot).

``PrefetchIterator`` overlaps host batch assembly with device compute via a
background thread (the host side of async dispatch).

A copy of the JAX package's ``data/pipeline.py`` (numpy and threads only):
the same seeds give the same batches byte for byte.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["SyntheticLMData", "PrefetchIterator", "pack_documents"]


class SyntheticLMData:
    """Deterministic Zipf token stream shaped like a causal-LM batch."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int, seed: int = 0,
                 zipf_a: float = 1.3):
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.zipf_a = zipf_a

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        raw = rng.zipf(self.zipf_a, size=(self.batch, self.seq_len + 1))
        toks = (raw - 1) % self.vocab_size
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
            "mask": np.ones((self.batch, self.seq_len), np.float32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def pack_documents(docs, seq_len: int, pad_id: int = 0, eos_id: int = 1):
    """Greedy sequence packing: concatenate docs with EOS, split into rows.

    Returns (tokens (N, seq_len), mask) — mask zeroes padding. Standard
    throughput trick: no row is mostly padding.
    """
    stream: list[int] = []
    for d in docs:
        stream.extend(int(t) for t in d)
        stream.append(eos_id)
    n = max(1, (len(stream) + seq_len - 1) // seq_len)
    out = np.full((n, seq_len), pad_id, np.int32)
    mask = np.zeros((n, seq_len), np.float32)
    for i in range(n):
        row = stream[i * seq_len : (i + 1) * seq_len]
        out[i, : len(row)] = row
        mask[i, : len(row)] = 1.0
    return out, mask


class PrefetchIterator:
    """Wrap an iterator with a bounded background prefetch queue."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        except BaseException as e:  # surfaced on next()
            self._err = e
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
