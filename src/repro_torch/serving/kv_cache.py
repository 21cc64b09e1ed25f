"""Paged KV-cache bookkeeping: host-side block allocator + block tables.

The device side lives in ``repro_torch.models.transformer`` (``init_paged_pools``,
``decode_step_paged``, ``scatter_prefill_cache``) — fixed pools of
(n_blocks, block_size, Hkv, hd) per layer run, written/read through a block
table.  This module owns the *host* state: which physical blocks are free,
which belong to which request, and how the (B_slots, max_blocks) int32 table
handed to the decode step is built.

Physical block 0 is reserved as the null block: the allocator never hands it
out, inactive batch slots keep all-zero tables, and their (masked) scatter
writes land there without touching live data.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["OutOfBlocks", "BlockAllocator", "blocks_needed",
           "build_block_tables"]


class OutOfBlocks(RuntimeError):
    """Raised by :meth:`BlockAllocator.alloc` when the pool is exhausted."""


def blocks_needed(n_tokens: int, block_size: int) -> int:
    """Physical blocks required to hold ``n_tokens`` cache entries."""
    return max(1, math.ceil(n_tokens / block_size))


@dataclasses.dataclass
class BlockAllocator:
    """Free-list allocator over a fixed pool of KV blocks.

    ``n_blocks`` counts the whole pool *including* the reserved null block 0,
    so ``capacity == n_blocks - 1`` blocks are actually allocatable — keep
    that in mind when sizing equal-memory paged-vs-dense comparisons.
    """

    n_blocks: int
    block_size: int

    def __post_init__(self) -> None:
        if self.n_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null block)")
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        # LIFO free list, low ids first out — deterministic for tests
        self._free = list(range(self.n_blocks - 1, 0, -1))

    @property
    def capacity(self) -> int:
        return self.n_blocks - 1

    @property
    def n_free(self) -> int:
        return len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int = 1) -> list[int]:
        """Take ``n`` blocks or raise :class:`OutOfBlocks` (all-or-nothing)."""
        if n > len(self._free):
            raise OutOfBlocks(f"want {n} blocks, {len(self._free)} free")
        taken = [self._free.pop() for _ in range(n)]
        return taken

    def free(self, blocks: list[int]) -> None:
        for b in blocks:
            if not 0 < b < self.n_blocks:
                raise ValueError(f"block id {b} out of range")
            if b in self._free:
                raise ValueError(f"double free of block {b}")
        # refill so freshly freed blocks come out low-id-first again
        self._free.extend(sorted(blocks, reverse=True))


def build_block_tables(tables: list[list[int]], max_blocks: int,
                       n_slots: int | None = None) -> np.ndarray:
    """Pack per-request block lists into the (n_slots, max_blocks) int32
    device table, padding unused entries (and whole inactive slots) with the
    null block 0."""
    n_slots = len(tables) if n_slots is None else n_slots
    out = np.zeros((n_slots, max_blocks), np.int32)
    for i, blks in enumerate(tables):
        if len(blks) > max_blocks:
            raise ValueError(f"request {i} has {len(blks)} blocks, table "
                             f"holds {max_blocks}")
        out[i, :len(blks)] = blks
    return out
