"""The port's continuous serving engine (DESIGN.md §12): chunked prefill
against a greedy loop built from the reference model API (the reference
``ServeEngine`` is red under the installed jax, ROADMAP R1), ragged ≡ solo
under chunking, exact preemption, the streaming events, the prefix cache
(hit ≡ cold, a near miss is not reused), validation, the registry-derived
stats, ``run()``'s per-call outcomes, and seeded sampling.  Every
comparison inside the port is of token ids, which must be equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch import obs
from repro_torch.serve import PromptTooLong, Request, ServeEngine
from repro_torch.serve.engine import _prompt_bucket

from _torch_small import small_models

S_MAX = 48
CHUNK = 8
LENS, MAX_NEW = (18, 25, 21), (4, 3, 5)


@pytest.fixture(scope="module")
def m():
    return small_models(backend="v3")


def _long(seed=0):
    """Prompts well past chunk_len so prefill takes several steps."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, 256, n), max_new_tokens=k)
            for i, (n, k) in enumerate(zip(LENS, MAX_NEW))]


def _engine(m, dense=False, slots=2, **kw):
    kw.setdefault("chunk_len", CHUNK)
    return ServeEngine(m.port_api, m.port_dense if dense else m.port_packed,
                       slots=slots, s_max=S_MAX, device="cpu",
                       backend=None if dense else "v3", **kw)


def _reference_tokens(m, req, chunk=CHUNK):
    """The chunk schedule of one request on the reference model API:
    ``prefill`` of the first ``chunk`` tokens with ``plen``, then
    ``decode_chunk`` over each tail chunk, then greedy ``decode_step``s."""
    params = jax.tree.map(jnp.asarray, m.dense)
    p = np.asarray(req.prompt, np.int32)
    feed = min(len(p), chunk)
    toks = np.zeros((1, _prompt_bucket(feed, S_MAX)), np.int32)
    toks[0, :feed] = p[:feed]
    logits, caches = m.api.prefill(params, {"tokens": jnp.asarray(toks)},
                                   s_max=S_MAX, plen=jnp.asarray([feed]))
    last, pos = np.asarray(logits)[0], feed
    while pos < len(p):
        q = min(len(p) - pos, chunk)
        lg, live, caches = m.api.decode_chunk(
            params, jnp.asarray(p[None, pos:pos + q]), caches,
            jnp.asarray([pos]), jnp.asarray([q]))
        assert np.asarray(live)[:, 0].all()
        last, pos = np.asarray(lg)[q - 1, 0], pos + q
    out = [int(last.argmax())]
    while len(out) < req.max_new_tokens:
        lg, caches = m.api.decode_step(params, jnp.asarray([[out[-1]]]),
                                       caches, jnp.asarray([pos]))
        out.append(int(np.asarray(lg).argmax()))
        pos += 1
    return out


def test_chunked_engine_matches_reference_model_api_loop(m):
    reqs = _long()
    stats = _engine(m, dense=True).run(reqs, max_steps=120)
    assert stats["completed"] == 3
    # prompts of 18/25/21 at chunk 8 take several prefill steps each
    assert stats["decode_steps"] > max(MAX_NEW)
    for r in reqs:
        assert r.out_tokens == _reference_tokens(m, r), r.rid


def test_chunked_ragged_equals_solo(m):
    ragged = _long()
    _engine(m).run(ragged, max_steps=120)
    for ref in _long():
        _engine(m, slots=1).run([ref], max_steps=120)
        assert ref.done and ragged[ref.rid].out_tokens == ref.out_tokens


def test_preemption_is_exact(m):
    kw = dict(slots=1, chunk_len=4)
    prompt = np.arange(12)
    ref = Request(rid=0, prompt=prompt, max_new_tokens=4)
    _engine(m, **kw).run([ref], max_steps=60)
    eng = _engine(m, **kw)
    req = eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=4))
    eng.pump()
    eng.step()                           # one chunk scored, still prefilling
    slot = eng.active.index(req)
    assert not req.out_tokens and eng.preempt(slot)
    assert eng.active[slot] is None and eng._queue[0] is req
    assert eng._m["preemptions"].value == 1
    steps = 0
    while not req.done:
        eng.pump()
        eng.step()
        steps += 1
        assert steps < 60
    assert req.out_tokens == ref.out_tokens
    # a row that has emitted is no longer preemptible
    eng2 = _engine(m, **kw)
    r2 = eng2.submit(Request(rid=1, prompt=np.arange(3), max_new_tokens=4))
    eng2.pump()
    assert r2.out_tokens and not eng2.preempt(eng2.active.index(r2))


def test_streaming_submit_poll_events(m):
    eng = _engine(m, slots=1)
    seen = []
    req = eng.submit(Request(rid=7, prompt=np.arange(13), max_new_tokens=3,
                             on_token=lambda r, t: seen.append(t)))
    events = []
    for _ in range(30):
        eng.pump()
        eng.step()
        events += eng.poll()
        if req.done:
            break
    events += eng.poll()
    assert req.done and seen == req.out_tokens and len(seen) == 3
    assert [e["token"] for e in events if e["kind"] == "token"] \
        == req.out_tokens
    kinds = [e["kind"] for e in events]
    assert kinds[-1] == "finish" and kinds.count("finish") == 1


def test_prefix_hit_equals_cold_and_near_miss_is_not_reused(m):
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, 21)
    other = base.copy()
    other[17:] = rng.integers(0, 256, 4)             # shares 17 tokens
    near = base.copy()
    near[3] = (near[3] + 1) % 256                    # differs inside page 0
    prompts = [base, base, other, near]
    cold = []
    for p in prompts:
        r = Request(rid=0, prompt=p, max_new_tokens=4)
        _engine(m, slots=1).run([r], max_steps=60)
        cold.append(r.out_tokens)
    eng = _engine(m, slots=1, prefix_cache=True, page_tokens=8)
    hot = [Request(rid=i, prompt=p, max_new_tokens=4)
           for i, p in enumerate(prompts)]
    eng.run(hot, max_steps=200)
    assert [r.out_tokens for r in hot] == cold
    # base snapshots at 8 and 16; the repeat and `other` restore the
    # 16-token entry; `near` matches no entry (exact token-id gate)
    assert eng._m["prefix_hits"].value == 2
    assert eng._m["prefix_misses"].value == 2
    # entries at 8 and 16 tokens: base's two and near's two
    assert eng._m["prefix_snapshots"].value == 4
    restores = [s.rid for s in eng.tracer.buffer.spans()
                if s.name == "restore"]
    assert restores == [1, 2]


def test_validation(m):
    with pytest.raises(ValueError, match="chunk_len"):
        _engine(m, chunk_len=0)
    with pytest.raises(ValueError, match="page_tokens"):
        _engine(m, page_tokens=-1)
    with pytest.raises(ValueError, match="page-aligned"):
        _engine(m, chunk_len=8, page_tokens=16, prefix_cache=True)
    eng = _engine(m, slots=1)
    long = Request(rid=5, prompt=np.zeros(S_MAX, np.int64))
    with pytest.raises(PromptTooLong):
        eng.add_request(long)
    assert long.outcome == "rejected"
    queued = eng.submit(Request(rid=6, prompt=np.zeros(S_MAX, np.int64)))
    assert eng.pump() == 0 and queued.outcome == "rejected"
    assert eng.poll()[-1] == {"kind": "reject", "rid": 6}


def test_defaults_follow_the_reference_and_env(m, monkeypatch):
    eng = ServeEngine(m.port_api, m.port_packed, slots=1, s_max=S_MAX,
                      device="cpu")
    assert (eng.chunk_len, eng.page_tokens, eng._prefix, eng.spec_depth,
            eng.spec_len) == (32, 16, None, None, 0)
    monkeypatch.setenv("SME_CHUNK_LEN", "16")
    monkeypatch.setenv("SME_PAGE_TOKENS", "8")
    monkeypatch.setenv("SME_PREFIX_CACHE", "on")
    eng = ServeEngine(m.port_api, m.port_packed, slots=1, s_max=S_MAX,
                      device="cpu")
    assert (eng.chunk_len, eng.page_tokens) == (16, 8)
    assert eng._prefix is not None


def test_stats_derive_from_the_registry(m):
    eng = _engine(m)
    stats = eng.run(_long(), max_steps=120)
    reg = obs.get_registry()
    for key, name in (("prefills", "serve_prefills_total"),
                      ("decode_steps", "serve_decode_steps_total"),
                      ("tokens", "serve_tokens_total")):
        assert stats[key] == reg.value(name, engine=eng._eid) > 0
    assert stats["tokens"] == sum(MAX_NEW) - 3       # first tokens: ttft
    flat = reg.flat_values()
    steps = sum(v for k, v in flat.items()
                if k.startswith("serve_step_seconds_count")
                and f'engine="{eng._eid}"' in k)
    assert steps == stats["decode_steps"]
    assert stats["decode_s"] == pytest.approx(sum(
        v for k, v in flat.items() if k.startswith("serve_step_seconds_sum")
        and f'engine="{eng._eid}"' in k))
    assert eng.step_ms()["chunked"][0] > 0
    assert reg.value("serve_requests_total", engine=eng._eid,
                     outcome="completed") == 3


def test_run_outcomes_sum_and_foreign_entries_survive(m):
    eng = _engine(m, slots=1)
    foreign = eng.submit(Request(rid=99, prompt=np.arange(4),
                                 max_new_tokens=2))
    mine = [Request(rid=0, prompt=np.arange(4), max_new_tokens=2),
            Request(rid=1, prompt=np.arange(5), max_new_tokens=2)]
    stats = eng.run(mine, max_steps=0)
    assert sum(stats[k] for k in ("completed", "evicted", "rejected",
                                  "unserved")) == 2
    assert stats["unserved"] == 2
    assert foreign in eng._queue and foreign.outcome is None
    for _ in range(30):
        eng.pump()
        eng.step()
        if foreign.done:
            break
    assert foreign.done
    # a cut-off run evicts what it started and leaves the rest unserved
    cut = [Request(rid=i, prompt=np.arange(4), max_new_tokens=20)
           for i in range(2)]
    stats = eng.run(cut, max_steps=2)
    assert (stats["evicted"], stats["unserved"]) == (1, 1)


def test_temperature_sampling_is_seeded(m):
    def served(seed):
        reqs = _long()
        reqs[1].temperature = 0.8
        _engine(m, seed=seed).run(reqs, max_steps=120)
        return [r.out_tokens for r in reqs]
    base = _long()
    _engine(m).run(base, max_steps=120)
    a, b, c = served(3), served(3), served(4)
    assert a == b
    assert a[1] != c[1]
    assert a[0] == c[0] == base[0].out_tokens and a[2] == base[2].out_tokens
