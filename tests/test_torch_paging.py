"""The port's block-table allocator (repro_torch/core/paging.py), a copy
of the framework-free `repro.core.paging`: driven through the same
hypothesis sequences of admit / ensure_capacity / finish, both allocators
must hold equal tables, free lists, refcounts, prefix caches and stats
after every operation; and the properties of tests/test_paging.py
(invariants under random workloads, sharing refcounts, eviction, an
OutOfBlocks that changes nothing) hold for the port's allocator.
Driven by hypothesis when installed, else the deterministic fallback
shim."""
import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # deterministic fallback (tests/_hypothesis_compat.py)
    from _hypothesis_compat import given, settings, strategies as st

from repro.core import paging as jpaging
from repro_torch.core.paging import AdmitResult, BlockAllocator, OutOfBlocks


def _state(alloc):
    return (list(alloc.free), list(alloc.ref), list(alloc.block_key),
            dict(alloc.cached), list(alloc.evictable),
            {s: list(t) for s, t in alloc.tables.items()}, dict(alloc.stats))


def _apply(alloc, out_of_blocks, action):
    """One admit / extend / finish on `alloc` -> what it returned, or the
    OutOfBlocks message."""
    kind, sid, arg = action
    try:
        if kind == "admit":
            r = alloc.admit(sid, arg, reserve=1)
            return r.table, r.n_shared_blocks, r.n_shared_tokens
        if kind == "extend":
            return alloc.ensure_capacity(sid, arg)
        return alloc.finish(sid)
    except out_of_blocks as e:
        return "out of blocks", str(e)


@settings(max_examples=25, deadline=None)
@given(st.integers(min_value=4, max_value=24),
       st.integers(min_value=2, max_value=8),
       st.lists(st.integers(min_value=0, max_value=2), min_size=1,
                max_size=60),
       st.integers(min_value=0, max_value=10_000))
def test_allocator_equals_reference_under_random_ops(num_blocks, block_size,
                                                      ops, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 100, 4 * block_size).tolist()
    pool = [base[: block_size + 1], base[: 2 * block_size + 3],
            base[: 3 * block_size], rng.integers(0, 100, block_size + 2)
            .tolist(), rng.integers(0, 100, 1).tolist()]
    mine = BlockAllocator(num_blocks, block_size)
    ref = jpaging.BlockAllocator(num_blocks, block_size)
    live: dict[int, int] = {}    # seq_id -> current length
    next_sid = 0
    for op in ops:
        if op == 0 or not live:
            action = ("admit", next_sid, pool[int(rng.integers(len(pool)))])
        else:
            sid = sorted(live)[int(rng.integers(len(live)))]
            action = ("extend" if op == 1 else "finish", sid, live[sid])
        got = _apply(mine, OutOfBlocks, action)
        want = _apply(ref, jpaging.OutOfBlocks, action)
        assert got == want
        assert _state(mine) == _state(ref)
        mine.check_invariants()
        kind, sid, arg = action
        failed = isinstance(got, tuple) and got[0] == "out of blocks"
        if kind == "admit":
            next_sid += 1
            if not failed:
                live[sid] = len(arg)
        elif kind == "extend" and not failed:
            live[sid] += 1
        elif kind == "finish":
            del live[sid]
    for sid in sorted(live):
        mine.finish(sid)
        ref.finish(sid)
    assert _state(mine) == _state(ref)


def _random_workload(alloc: BlockAllocator, ops: list, prompt_pool: list):
    """Interpret a generated op list against the allocator, checking the
    invariants after EVERY operation."""
    rng = np.random.default_rng(0xC0FFEE)
    live: dict[int, int] = {}   # seq_id -> current length
    next_sid = 0
    for op in ops:
        if op == 0 or not live:          # admit
            prompt = prompt_pool[int(rng.integers(len(prompt_pool)))]
            try:
                alloc.admit(next_sid, prompt, reserve=1)
                live[next_sid] = len(prompt)
                next_sid += 1
            except OutOfBlocks:
                pass                     # pool full: a valid outcome
        elif op == 1:                    # extend (one decode step)
            sid = list(live)[int(rng.integers(len(live)))]
            try:
                alloc.ensure_capacity(sid, live[sid])
                live[sid] += 1
            except OutOfBlocks:
                pass
        else:                            # finish
            sid = list(live)[int(rng.integers(len(live)))]
            alloc.finish(sid)
            del live[sid]
        alloc.check_invariants()
    for sid in list(live):
        alloc.finish(sid)
    alloc.check_invariants()


@settings(max_examples=20, deadline=None)
@given(st.integers(min_value=4, max_value=24),
       st.integers(min_value=2, max_value=8),
       st.lists(st.integers(min_value=0, max_value=2), min_size=1,
                max_size=60),
       st.integers(min_value=0, max_value=10_000))
def test_allocator_invariants_random_ops(num_blocks, block_size, ops, seed):
    rng = np.random.default_rng(seed)
    # a pool of prompts with overlapping prefixes so sharing triggers
    base = rng.integers(0, 100, 4 * block_size).tolist()
    prompt_pool = [
        base[: block_size + 1],
        base[: 2 * block_size + 3],
        base[: 3 * block_size],
        rng.integers(0, 100, block_size + 2).tolist(),
        rng.integers(0, 100, 1).tolist(),
    ]
    _random_workload(BlockAllocator(num_blocks, block_size),
                     ops, prompt_pool)


def test_all_blocks_free_after_everything_finishes():
    alloc = BlockAllocator(16, 4)
    for sid, n in enumerate((3, 9, 17)):
        alloc.admit(sid, list(range(n)))
    for sid in range(3):
        alloc.finish(sid)
    alloc.check_invariants()
    # registered blocks stay cached (warm), the rest return to free; all
    # 16 are reclaimable and none active
    assert alloc.n_free() == 16
    assert all(r == 0 for r in alloc.ref)


def test_prefix_sharing_refcounts():
    alloc = BlockAllocator(16, 4)
    prompt = list(range(10))              # blocks: 2 full + 1 tail
    r1 = alloc.admit(1, prompt)
    assert isinstance(r1, AdmitResult) and r1.n_shared_blocks == 0
    r2 = alloc.admit(2, prompt)
    assert r2.n_shared_blocks == 2        # both full blocks re-used
    assert r2.table[:2] == r1.table[:2]
    assert r2.table[2] != r1.table[2]     # tail is private
    shared = r1.table[:2]
    assert all(alloc.ref[b] == 2 for b in shared)
    alloc.finish(1)
    alloc.check_invariants()
    assert all(alloc.ref[b] == 1 for b in shared), \
        "refcount must stay >0 while a sharer lives"
    alloc.finish(2)
    assert all(alloc.ref[b] == 0 for b in shared), \
        "refcount must reach 0 when the last sharer finishes"
    alloc.check_invariants()


def test_shared_block_never_freed_while_referenced():
    alloc = BlockAllocator(8, 4)
    prompt = list(range(9))
    alloc.admit(1, prompt)
    alloc.admit(2, prompt)
    alloc.finish(1)
    # burn through the free list; the evictable cache may be raided but
    # seq 2's referenced blocks must survive
    t2 = alloc.table(2)
    sids = []
    for sid in range(3, 20):
        try:
            alloc.admit(sid, [100 + sid])
            sids.append(sid)
        except OutOfBlocks:
            break
        alloc.check_invariants()
    assert alloc.table(2) == t2
    assert all(alloc.ref[b] >= 1 for b in t2)
    for sid in [2] + sids:
        alloc.finish(sid)
    alloc.check_invariants()


def test_eviction_reclaims_cached_blocks():
    alloc = BlockAllocator(6, 2)
    alloc.admit(1, list(range(8)))        # 4 full + 1 reserve = 5 blocks
    alloc.finish(1)                       # 4 registered, 1 free + 1 never used
    assert len(alloc.cached) == 4
    # a new prompt with a different prefix must evict LRU cached blocks
    alloc.admit(2, list(range(50, 58)))
    alloc.check_invariants()
    assert alloc.stats["evictions"] >= 3
    alloc.finish(2)


def test_out_of_blocks_leaves_state_unchanged():
    alloc = BlockAllocator(4, 2)
    alloc.admit(1, list(range(5)))        # 3 blocks + reserve = 4: pool full
    before = (list(alloc.free), list(alloc.ref), dict(alloc.cached))
    with pytest.raises(OutOfBlocks):
        alloc.admit(2, list(range(20, 29)))
    assert (list(alloc.free), list(alloc.ref), dict(alloc.cached)) == before
    alloc.check_invariants()
    alloc.finish(1)


def test_admit_rejects_duplicate_seq_and_empty():
    alloc = BlockAllocator(4, 2)
    alloc.admit(1, [1, 2, 3])
    with pytest.raises(AssertionError):
        alloc.admit(1, [1, 2, 3])
    with pytest.raises(AssertionError):
        alloc.admit(2, [])
