"""Deterministic token data pipeline: the port's copy of
``repro.data.pipeline`` (numpy only; batches identical to the JAX
package's for every seed and step).

Two sources: a seeded synthetic stream (always available — CI / smoke) and
a memmapped token file (production path: one uint32 file per corpus shard).
Per-host sharding: host h of H reads batch rows [h*B/H, (h+1)*B/H) — the
global order is a pure function of (seed, step), so elastic restarts and
host failures resume exactly (fault_tolerance.RestartManifest records the
step; the pipeline skips to it in O(1)).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    token_file: Optional[str] = None     # memmap uint32; None -> synthetic
    host_index: int = 0
    host_count: int = 1


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.host_count:
            raise ValueError(f"global batch {cfg.global_batch} does not split over "
                             f"{cfg.host_count} hosts")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.host_count
        self._mm = None
        if cfg.token_file:
            self._mm = np.memmap(cfg.token_file, dtype=np.uint32, mode="r")

    # ------------------------------------------------------------------
    def batch_at(self, step: int) -> dict:
        """Pure function of step -> {tokens, targets, mask} (local shard)."""
        cfg = self.cfg
        lo = cfg.host_index * self.local_batch
        if self._mm is not None:
            n_tok = self._mm.shape[0]
            n_seq = max((n_tok - 1) // cfg.seq_len, 1)
            rng = np.random.RandomState(
                (cfg.seed * 1_000_003 + step) % (2 ** 31 - 1))
            seq_idx = rng.randint(0, n_seq, size=cfg.global_batch)[
                lo:lo + self.local_batch]
            starts = seq_idx * cfg.seq_len
            tok = np.stack([self._mm[s:s + cfg.seq_len + 1]
                            for s in starts]).astype(np.int32)
        else:
            # synthetic: seeded per (step, row) — deterministic & cheap
            rng = np.random.RandomState(
                (cfg.seed * 1_000_003 + step) % (2 ** 31 - 1))
            tok = rng.randint(0, cfg.vocab_size,
                              size=(cfg.global_batch, cfg.seq_len + 1),
                              ).astype(np.int32)[lo:lo + self.local_batch]
        tokens = tok[:, :-1]
        targets = tok[:, 1:]
        mask = np.ones_like(targets, np.float32)
        return {"tokens": tokens, "targets": targets, "mask": mask}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
