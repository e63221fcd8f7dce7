"""The port's host data (``repro_torch.data``) against the reference's
``repro.data``: the synthetic streams bitwise for the same seeds, and the
pipeline's prefetch, sharding and key check as ``test_substrate.py``
holds the reference's."""
import numpy as np
import pytest

from repro.data import synthetic as ref_syn
from repro_torch.data import (Prefetcher, checked_iterator, image_task,
                              lm_batches, markov_table, shard_batch,
                              token_stats)

FRONTENDS = {"plain": None,
             "vision": {"kind": "vision_stub", "n": 5, "d": 16},
             "audio": {"kind": "audio_stub", "src": 12, "d": 16}}


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("vocab,branch,seed", [(64, 16, 0), (300, 4, 7)])
def test_markov_table_bitwise(vocab, branch, seed):
    _same(markov_table(vocab, branch, seed),
          ref_syn.markov_table(vocab, branch, seed))


@pytest.mark.parametrize("frontend", list(FRONTENDS))
def test_lm_batches_bitwise(frontend):
    fe = FRONTENDS[frontend]
    got = lm_batches(97, 3, 20, seed=5, frontend=fe)
    ref = ref_syn.lm_batches(97, 3, 20, seed=5, frontend=fe)
    for _ in range(3):
        a, b = next(got), next(ref)
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    table = markov_table(97, 8, 2)
    a = next(lm_batches(97, 2, 9, seed=1, table=table))
    b = next(ref_syn.lm_batches(97, 2, 9, seed=1, table=table))
    for k in a:
        _same(a[k], b[k])


@pytest.mark.parametrize("n,size,seed", [(64, 8, 0), (33, 12, 99)])
def test_image_task_bitwise(n, size, seed):
    for a, b in zip(image_task(n, size=size, seed=seed),
                    ref_syn.image_task(n, size=size, seed=seed)):
        _same(a, b)


def test_token_stats_equal():
    assert token_stats(lm_batches(50, 4, 16, seed=3), 3) == \
        ref_syn.token_stats(ref_syn.lm_batches(50, 4, 16, seed=3), 3)


def test_markov_stream_learnable_structure():
    b = next(lm_batches(vocab=64, batch=4, seq=32, seed=0))
    assert b["tokens"].shape == (4, 32)
    assert (b["labels"][:, :-1] == b["tokens"][:, 1:]).all()


def test_prefetcher_and_shard():
    it = Prefetcher(lm_batches(vocab=16, batch=8, seq=4), depth=2)
    b = next(it)
    s0 = shard_batch(b, 0, 4)
    s3 = shard_batch(b, 3, 4)
    assert s0["tokens"].shape == (2, 4)
    assert (s3["tokens"] == b["tokens"][6:]).all()
    it.close()


def test_prefetcher_ends_and_reraises():
    assert list(Prefetcher(iter(range(5)), depth=2)) == [0, 1, 2, 3, 4]

    def broken():
        yield 1
        raise RuntimeError("producer failed")
    it = Prefetcher(broken())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="producer failed"):
        next(it)


def test_checked_iterator():
    it = checked_iterator(lm_batches(16, 2, 4), ("tokens", "labels"))
    assert set(next(it)) == {"tokens", "labels"}
    next(it)
    with pytest.raises(ValueError, match="missing"):
        next(checked_iterator(lm_batches(16, 2, 4), ("tokens", "mask")))
