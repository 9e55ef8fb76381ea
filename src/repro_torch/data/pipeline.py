"""Deterministic synthetic data pipeline for training runs.

Generates seeded token streams with a Zipfian-ish marginal + local structure
(n-gram echo) so that a small LM actually has something learnable, plus
next-token labels. Double-buffered host-side prefetch thread so the train
loop never waits on generation.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class TokenBatch:
    tokens: np.ndarray    # [B, S] int32
    labels: np.ndarray    # [B, S] int32 (next token, last = first)


class SyntheticTextPipeline:
    def __init__(self, vocab_size: int, batch: int, seq: int, seed: int = 0,
                 zipf_a: float = 1.2, echo_prob: float = 0.3,
                 prefetch: int = 2):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.zipf_a = zipf_a
        self.echo_prob = echo_prob
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._step = 0

    # ----------------------------------------------------------- generation
    def _gen(self, step: int) -> TokenBatch:
        rng = np.random.default_rng((self.seed, step))
        # zipf marginal truncated to vocab
        z = rng.zipf(self.zipf_a, size=(self.batch, self.seq))
        toks = np.minimum(z - 1, self.vocab - 1).astype(np.int32)
        # local structure: with prob echo_prob, token t = token t-2
        echo = rng.random((self.batch, self.seq)) < self.echo_prob
        toks[:, 2:] = np.where(echo[:, 2:], toks[:, :-2], toks[:, 2:])
        labels = np.roll(toks, -1, axis=1)
        return TokenBatch(toks, labels)

    def __iter__(self) -> Iterator[TokenBatch]:
        return self

    def __next__(self) -> TokenBatch:
        if self._thread is None:
            b = self._gen(self._step)
            self._step += 1
            return b
        return self._q.get()

    # ------------------------------------------------------------- prefetch
    def start(self) -> "SyntheticTextPipeline":
        def loop():
            step = 0
            while not self._stop:
                try:
                    self._q.put(self._gen(step), timeout=0.2)
                    step += 1
                except queue.Full:
                    continue
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop = True
        while not self._q.empty():
            self._q.get_nowait()
