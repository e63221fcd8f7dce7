"""``repro_torch.serve.paged`` (a copy of the reference's numpy-only
module) against ``repro.serve.paged``: the same seeded random operation
sequences on both give the same page ids, refcounts, lookups, evictions
and rollbacks, and both reject a forged-digest near miss.  Exact
equality throughout: the module is integer bookkeeping."""
import numpy as np
import pytest

from repro.serve import paged as ref
from repro_torch.serve import paged as port


def _state(alloc):
    return (alloc.in_use, [alloc.refcount(p) for p in range(alloc.n_pages)])


def _entry(e):
    return None if e is None else (e.length, tuple(e.page_ids), e.entry_slot,
                                   e.tokens.tolist())


@pytest.mark.parametrize("seed", range(4))
def test_allocator_matches_reference(seed):
    rng = np.random.default_rng(seed)
    a, b = ref.PageAllocator(5), port.PageAllocator(5)
    held = []
    for _ in range(300):
        op = rng.integers(3)
        if op == 0 or not held:
            got = a.alloc()
            assert b.alloc() == got
            if got is not None:
                held.append(got)
        elif op == 1:
            p = held[rng.integers(len(held))]
            a.retain(p)
            b.retain(p)
            held.append(p)
        else:
            p = held.pop(rng.integers(len(held)))
            a.release(p)
            b.release(p)
        assert _state(a) == _state(b)
    for mod in (ref, port):
        al = mod.PageAllocator(1)
        al.release(al.alloc())
        with pytest.raises((ValueError, KeyError)):
            al.release(0)


@pytest.mark.parametrize("seed", range(6))
def test_prefix_index_matches_reference(seed):
    """prepare/commit/abort/lookup/has over token chains from a 2-symbol
    alphabet (so chains share pages and lookups hit often), with pool and
    entry sizes small enough that eviction and exhaustion happen."""
    rng = np.random.default_rng(seed)
    ia = ref.PrefixIndex(ref.PageAllocator(6), 3, 2)
    ib = port.PrefixIndex(port.PageAllocator(6), 3, 2)
    for _ in range(200):
        toks = rng.integers(0, 2, int(rng.integers(0, 3)) * 2 + 2
                            ).astype(np.int32)
        op = rng.integers(3)
        if op == 0:
            pa, pb = ia.prepare(toks), ib.prepare(toks)
            assert (pa is None) == (pb is None)
            if pa is not None:
                assert pa.first_new == pb.first_new
                assert _entry(pa.entry) == _entry(pb.entry)
                if rng.random() < 0.8:
                    ia.commit(pa)
                    ib.commit(pb)
                else:
                    ia.abort(pa)
                    ib.abort(pb)
        elif op == 1:
            prompt = np.concatenate([toks, rng.integers(0, 2, 2)])
            max_len = int(rng.integers(0, len(prompt)))
            assert _entry(ia.lookup(prompt, max_len)) == \
                _entry(ib.lookup(prompt, max_len))
        else:
            assert ia.has(toks) == ib.has(toks)
        assert _state(ia.alloc) == _state(ib.alloc)
        assert (len(ia), ia.hits, ia.misses, ia.evictions) == \
            (len(ib), ib.hits, ib.misses, ib.evictions)
        assert sorted(map(_entry, ia.entries)) == \
            sorted(map(_entry, ib.entries))
    assert ia.evictions > 0 and ia.hits > 0


def test_rollback_and_length_validation_match_reference():
    for mod in (ref, port):
        al = mod.PageAllocator(3)
        pinned = al.alloc()
        ix = mod.PrefixIndex(al, 4, 2)
        assert ix.prepare(np.arange(6, dtype=np.int32)) is None
        assert al.in_use == 1
        ok = ix.prepare(np.arange(4, dtype=np.int32))
        ix.abort(ok)
        assert al.in_use == 1 and not ix.has(np.arange(4, dtype=np.int32))
        al.release(pinned)
        with pytest.raises(ValueError, match="multiple"):
            ix.prepare(np.arange(3, dtype=np.int32))


def test_forged_digest_near_miss_is_rejected():
    """Exactness is not delegated to the hash: an entry reachable under a
    prompt's digest (a simulated collision) is still not reused."""
    for mod in (ref, port):
        ix = mod.PrefixIndex(mod.PageAllocator(8), 4, 2)
        ix.commit(ix.prepare(np.array([1, 2], np.int32)))
        ent = ix._entries[mod._digest(np.array([1, 2], np.int32))]
        ix._entries[mod._digest(np.array([3, 4], np.int32))] = ent
        assert ix.lookup(np.array([3, 4, 5], np.int32), 2) is None
        assert ix.lookup(np.array([1, 2, 5], np.int32), 2) is ent
