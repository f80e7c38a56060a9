"""Sharded, deterministic, resumable input pipeline with prefetch: the
reference's ``repro.data.pipeline``, copied (pure numpy and threads; the
batches are bitwise the reference's).

Properties required at pod scale:
* **host sharding** — host h of H reads only indices i with i % H == h;
* **determinism** — batch content is a pure function of (seed, step), so
  a restarted job resumes bit-identically from the checkpointed step;
* **resumability** — iterator state is just an integer step, stored
  inside the train checkpoint;
* **prefetch** — a background thread keeps ``depth`` batches ready
  (the training-side sibling of SMOL's producer/consumer pipelining).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np


class ShardedBatchSource:
    """Wraps a pure batch function into a sharded, seekable source.

    ``batch_fn(seed, global_step, host_index, host_count) -> batch dict``
    must be deterministic.
    """

    def __init__(
        self,
        batch_fn: Callable[[int, int, int, int], dict],
        seed: int = 0,
        host_index: int = 0,
        host_count: int = 1,
    ):
        self.batch_fn = batch_fn
        self.seed = seed
        self.host_index = host_index
        self.host_count = host_count

    def batch_at(self, step: int) -> dict:
        return self.batch_fn(self.seed, step, self.host_index, self.host_count)

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchIterator:
    """Background-thread prefetch of a batch iterator (depth-bounded)."""

    def __init__(self, source: ShardedBatchSource, start_step: int = 0, depth: int = 2):
        self.source = source
        self.step = start_step
        self.depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        step, batch = self._q.get()
        self.step = step + 1  # checkpointable position
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=1.0)


def synthetic_lm_batch_fn(vocab_size: int, batch: int, seq_len: int):
    """Zipfian bigram stream: learnable structure (each token biases its
    successor), deterministic per (seed, step, host)."""

    def fn(seed: int, step: int, host_index: int, host_count: int) -> dict:
        rng = np.random.default_rng((seed, step, host_index))
        local = batch // host_count
        base = rng.zipf(1.5, size=(local, seq_len + 1)).astype(np.int64)
        tokens = base % vocab_size
        # bigram structure: with p=0.5, next token = (prev * 7 + 1) % V
        follow = rng.random((local, seq_len)) < 0.5
        nxt = (tokens[:, :-1] * 7 + 1) % vocab_size
        tokens[:, 1:] = np.where(follow, nxt, tokens[:, 1:])
        return {"tokens": tokens.astype(np.int32)}

    return fn
