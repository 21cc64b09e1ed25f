"""Deterministic synthetic data pipeline, sharded by host.

Copy of ``repro/data/pipeline.py`` (numpy only; its ``global_batch``
places the batch on a JAX mesh and is not ported).  Tokens are a stateless
hash of (step, global position), equal to the reference's bit for bit, so
any host can regenerate any shard and the pipeline state is just the step
counter.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..configs.shapes import AUDIO_SRC_FRACTION, VISION_PATCHES, ShapeSpec
from ..models.config import ModelConfig

__all__ = ["DataPipeline"]

_MIX = np.uint64(0x9E3779B97F4A7C15)


def _hash_tokens(step: int, lo: int, hi: int, vocab: int, salt: int = 0) -> np.ndarray:
    """Deterministic tokens for flat global indices [lo, hi)."""
    idx = np.arange(lo, hi, dtype=np.uint64)
    with np.errstate(over="ignore"):  # intentional mod-2^64 hashing
        x = (idx + np.uint64(step + 1) * _MIX
             + np.uint64(salt) * np.uint64(0xDA442D24)) \
            * np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(31)
    return (x % np.uint64(vocab)).astype(np.int32)


@dataclasses.dataclass
class DataPipeline:
    cfg: ModelConfig
    shape: ShapeSpec
    host_id: int = 0
    num_hosts: int = 1

    def _local_rows(self) -> tuple[int, int]:
        B = self.shape.global_batch
        per = B // self.num_hosts
        return self.host_id * per, per

    def host_batch(self, step: int) -> dict[str, np.ndarray]:
        """This host's slice of the global batch for ``step`` (numpy)."""
        row0, rows = self._local_rows()
        S = self.shape.seq_len
        cfg = self.cfg
        out: dict[str, np.ndarray] = {}
        if cfg.enc_dec:
            s_src = int(S * AUDIO_SRC_FRACTION)
            s_tgt = S - s_src
            t = self._tok(step, row0, rows, s_tgt + 1, salt=1)
            out["src_embeds"] = self._embeds(step, row0, rows, s_src)
            out["tokens"], out["labels"] = t[:, :-1], t[:, 1:]
        elif cfg.frontend == "vision":
            n_img = min(VISION_PATCHES, S // 4)
            t = self._tok(step, row0, rows, S - n_img + 1, salt=1)
            out["embeds"] = self._embeds(step, row0, rows, n_img)
            out["tokens"], out["labels"] = t[:, :-1], t[:, 1:]
        else:
            t = self._tok(step, row0, rows, S + 1, salt=1)
            out["tokens"], out["labels"] = t[:, :-1], t[:, 1:]
        return out

    def _tok(self, step, row0, rows, width, salt=0) -> np.ndarray:
        lo = row0 * width
        t = _hash_tokens(step, lo, lo + rows * width, self.cfg.vocab, salt)
        return t.reshape(rows, width)

    def _embeds(self, step, row0, rows, s) -> np.ndarray:
        base = _hash_tokens(step, row0 * s, (row0 + rows) * s, 1 << 16, salt=7)
        x = (base.reshape(rows, s, 1).astype(np.float32) / (1 << 15)) - 1.0
        d = self.cfg.d_model
        phase = np.arange(d, dtype=np.float32) / d
        return (np.sin(x * 6.28318 + phase) / np.sqrt(d)).astype(np.float32)
