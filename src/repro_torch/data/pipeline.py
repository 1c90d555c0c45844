"""Deterministic synthetic data pipeline with packing and host sharding
(the port of ``repro.data.pipeline``: numpy on the host, so its batches
are bit-equal to the reference's for the same (seed, step, host)).

A real deployment swaps the generator for a tokenized corpus reader; the
rest (packing, host sharding, prefetch, checkpointable position) is the
production path.  Determinism: batch ``i`` is a pure function of (seed, i,
host_id), so restarts resume exactly — the pipeline position is part of the
checkpoint.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class SyntheticPipeline:
    cfg: ModelConfig
    batch_size: int
    seq_len: int
    seed: int = 0
    host_id: int = 0
    host_count: int = 1
    mean_doc_len: int = 256
    prefetch: int = 2

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.host_id)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step, host): pack documents into (B, S+1)
        then split into inputs/labels."""
        rng = self._rng(step)
        B, S = self.batch_size // self.host_count, self.seq_len
        V = max(self.cfg.vocab_size, 4)
        toks = np.empty((B, S + 1), np.int32)
        for b in range(B):
            pos = 0
            while pos < S + 1:
                n = min(int(rng.exponential(self.mean_doc_len)) + 2,
                        S + 1 - pos)
                # zipf-ish unigram stream with a BOS marker
                doc = (rng.zipf(1.3, size=n) % (V - 2)) + 2
                doc[0] = 1                                   # BOS
                toks[b, pos:pos + n] = doc
                pos += n
        out: Dict[str, np.ndarray] = {"labels": toks[:, 1:]}
        if self.cfg.embed_inputs:
            out["tokens"] = toks[:, :-1]
        else:
            emb = rng.standard_normal(
                (B, S, self.cfg.media_embed_dim)).astype(np.float32)
            out["embeddings"] = emb
        if self.cfg.family == "vlm":
            out["media"] = rng.standard_normal(
                (B, self.cfg.n_media_tokens, self.cfg.media_embed_dim)
            ).astype(np.float32)
        return out

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Prefetching iterator (one producer thread) starting at a step —
        the straggler-mitigation hook lives here: the producer stays ahead
        of the consumer so host-side hiccups don't stall the device step."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            step = start_step
            while not stop.is_set():
                try:
                    q.put(self.batch_at(step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def make_batch_fn(cfg: ModelConfig, batch_size: int, seq_len: int,
                  seed: int = 0):
    pipe = SyntheticPipeline(cfg, batch_size, seq_len, seed)
    return pipe.batch_at
