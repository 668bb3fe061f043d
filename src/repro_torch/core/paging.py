"""Block-table paged KV-cache bookkeeping (vLLM-style, host side), a copy
of the framework-free `repro.core.paging`, held equal to it by
tests/test_torch_paging.py.

The cache is a single pool of fixed-size BLOCKS; each sequence owns a
*block table* (list of block ids), positions map to
``(table[pos // block_size], pos % block_size)``, and blocks are handed
out lazily as decode crosses block boundaries.

Prefix sharing: the KV contents of a block holding positions
``[i*bs, (i+1)*bs)`` depend only on the prompt prefix ``tokens[:(i+1)*bs]``
(causal attention), so full prompt blocks are registered under that exact
prefix (the token tuple itself -- no hash collisions) and later requests
with the same prefix re-use them with a refcount instead of recomputing
prefill for those positions.  Only *full* blocks are ever shared; the
tail block of a prompt is always private because decode writes into it.
Registered blocks whose refcount drops to zero stay warm in an LRU until
pool pressure evicts them.

This module is pure host-side bookkeeping (python ints and lists); the
device-side gather/scatter that consumes the block tables lives in
``repro_torch.models.layers`` (paged_*) and the serve loop in
``repro_torch.launch.serve_loop`` (PagedServeLoop).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional, Sequence


class OutOfBlocks(RuntimeError):
    """Raised when an allocation cannot be satisfied even after evicting
    every unreferenced cached block.  Callers (the serve loop) respond by
    delaying admission or preempting a live sequence."""


@dataclasses.dataclass
class AdmitResult:
    table: list                 # block ids covering the prompt
    n_shared_blocks: int        # leading blocks re-used from the prefix cache
    block_size: int

    @property
    def n_shared_tokens(self) -> int:
        return self.n_shared_blocks * self.block_size


class BlockAllocator:
    """Fixed pool of ``num_blocks`` KV blocks of ``block_size`` positions.

    Every block is in exactly ONE of three states at all times:
      * free      -- on the free list, contents meaningless;
      * active    -- referenced by >= 1 live sequence (refcount > 0);
      * cached    -- refcount == 0 but registered in the prefix cache
                     (evictable LRU, reusable by a future admit).
    ``check_invariants()`` asserts this partition; the property tests in
    tests/test_torch_paging.py drive it through randomized
    admit/extend/finish sequences.
    """

    def __init__(self, num_blocks: int, block_size: int):
        assert num_blocks > 0 and block_size > 0
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.free: list[int] = list(range(num_blocks))
        self.ref = [0] * num_blocks
        self.block_key: list[Optional[tuple]] = [None] * num_blocks
        self.cached: dict[tuple, int] = {}         # prefix key -> block id
        self.evictable: OrderedDict[int, None] = OrderedDict()  # ref==0 cached
        self.tables: dict[int, list[int]] = {}     # seq_id -> block table
        self.stats = {"shared_blocks": 0, "evictions": 0, "allocs": 0}

    # -- low-level ------------------------------------------------------
    def n_free(self) -> int:
        """Blocks obtainable without touching active sequences."""
        return len(self.free) + len(self.evictable)

    def _take_block(self) -> int:
        if self.free:
            b = self.free.pop()
        elif self.evictable:
            b, _ = self.evictable.popitem(last=False)   # LRU eviction
            del self.cached[self.block_key[b]]
            self.block_key[b] = None
            self.stats["evictions"] += 1
        else:
            raise OutOfBlocks(
                f"no free blocks (pool={self.num_blocks}, all active)")
        self.ref[b] = 1
        self.stats["allocs"] += 1
        return b

    def _ref_block(self, b: int) -> None:
        if self.ref[b] == 0:
            self.evictable.pop(b)     # was cached; now active again
        self.ref[b] += 1

    def _unref_block(self, b: int) -> None:
        assert self.ref[b] > 0, f"double free of block {b}"
        self.ref[b] -= 1
        if self.ref[b] == 0:
            if self.block_key[b] is not None:
                self.evictable[b] = None       # stays warm in prefix cache
            else:
                self.free.append(b)

    # -- sequence lifecycle --------------------------------------------
    def admit(self, seq_id: int, tokens: Sequence[int],
              reserve: int = 1) -> AdmitResult:
        """Build a block table covering ``tokens`` (+ ``reserve`` decode
        positions), sharing leading full blocks with the prefix cache.

        The last prompt token is never covered by a shared block (its
        logits must be computed to emit the first generated token), so at
        most ``(len(tokens)-1) // block_size`` blocks are shared.
        Raises OutOfBlocks (with no state change) when the pool cannot
        cover the private remainder.
        """
        assert seq_id not in self.tables, f"seq {seq_id} already admitted"
        bs = self.block_size
        T = len(tokens)
        assert T > 0
        need_total = (T + reserve + bs - 1) // bs
        key_tokens = tuple(int(t) for t in tokens)

        shared: list[int] = []
        for i in range((T - 1) // bs):
            key = key_tokens[: (i + 1) * bs]
            b = self.cached.get(key)
            if b is None:
                break
            shared.append(b)
        n_private = need_total - len(shared)
        # blocks we are about to re-reference no longer count as reclaimable
        avail = self.n_free() - sum(1 for b in shared if b in self.evictable)
        if n_private > avail:
            raise OutOfBlocks(
                f"need {n_private} blocks for seq {seq_id}, "
                f"have {avail} reclaimable")

        for b in shared:
            self._ref_block(b)
        table = shared + [self._take_block() for _ in range(n_private)]
        self.tables[seq_id] = table
        self.stats["shared_blocks"] += len(shared)
        # register this prompt's full PRIVATE blocks for future sharing
        # (their KV is written by prefill and never touched again: decode
        # writes start at position T, i.e. in block T//bs or later)
        for i in range(len(shared), T // bs):
            key = key_tokens[: (i + 1) * bs]
            if key not in self.cached:
                self.cached[key] = table[i]
                self.block_key[table[i]] = key
        return AdmitResult(list(table), len(shared), bs)

    def ensure_capacity(self, seq_id: int, pos: int) -> bool:
        """Grow seq's table so position ``pos`` is addressable.  Returns
        True when the table changed.  Raises OutOfBlocks when the pool is
        exhausted (caller preempts)."""
        table = self.tables[seq_id]
        grew = False
        while pos // self.block_size >= len(table):
            table.append(self._take_block())
            grew = True
        return grew

    def finish(self, seq_id: int) -> None:
        """Release seq's references; cached blocks stay warm, private
        blocks return to the free list."""
        for b in self.tables.pop(seq_id):
            self._unref_block(b)

    def table(self, seq_id: int) -> list[int]:
        return list(self.tables[seq_id])

    # -- invariants -----------------------------------------------------
    def check_invariants(self) -> None:
        free = set(self.free)
        cached0 = set(self.evictable)
        active = {b for b in range(self.num_blocks) if self.ref[b] > 0}
        assert not (free & cached0), "block both free and cached"
        assert not (free & active), "block both free and active"
        assert not (cached0 & active), "block both cached-idle and active"
        assert len(free) + len(cached0) + len(active) == self.num_blocks, (
            f"pool leak: {len(free)} free + {len(cached0)} cached + "
            f"{len(active)} active != {self.num_blocks}")
        # refcount == number of live tables containing the block
        counts = [0] * self.num_blocks
        for table in self.tables.values():
            seen = set()
            for b in table:
                assert b not in seen, "block repeated within one table"
                seen.add(b)
                counts[b] += 1
        assert counts == self.ref, (
            "refcounts diverge from table membership: "
            f"{[(b, self.ref[b], counts[b]) for b in range(self.num_blocks) if self.ref[b] != counts[b]]}")
        # every cached key points at a block that remembers the key
        for key, b in self.cached.items():
            assert self.block_key[b] == key
        # a block shared by 2+ tables must be registered (full prefix)
        for b in range(self.num_blocks):
            if counts[b] > 1:
                assert self.block_key[b] is not None, (
                    f"unregistered block {b} shared by {counts[b]} tables")
