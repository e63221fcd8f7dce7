"""The continuous engine on sliding-window layers: gemma3-12b scaled down
(``scale_down(d_model=128, d_ff=256, head_dim=32, n_heads=4, n_kv_heads=2,
vocab=256, dtype="float32")``: 5 local layers with rings of W = 8 slots, 1
global layer, untied head, every linear packed to v3) served with prompts
of 20-30 tokens, so every ring wraps several times.

Chunked, prefix-cached and speculative tokens equal a greedy loop on the
reference model API (its ``prefill`` of the first ``chunk_len`` tokens,
then one ``decode_step`` per prompt token and per new token: what its
``decode_chunk`` scan runs), on the reference's ``xla`` backend; the port
serves through the v3 kernels' plain versions.  Inside the port every
comparison is of token ids or cache bytes, which must be equal: a draft
leaves the rings as it found them (the in-place draft of the full-length
caches would overwrite positions the verify step still reads), and a
prefix hit restores the rings of a cold admission bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS, scale_down as ref_scale_down
from repro.core.backend import use_backend
from repro.core.integrate import convert_params_to_sme as ref_convert
from repro.models import build_model as ref_build_model
from repro_torch.configs import ARCHS, scale_down
from repro_torch.convert import from_reference
from repro_torch.models.model import build_model
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.engine import _prompt_bucket

SMALL = dict(d_model=128, d_ff=256, head_dim=32, n_heads=4, n_kv_heads=2,
             vocab=256, dtype="float32")
S_MAX = 48
CHUNK = 8
W = 8



@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: these models are tiny, and test workers that
    each spread tiny ops over every core slow each other down many
    times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def m():
    cfg = ref_scale_down(REF_ARCHS["gemma3-12b"], **SMALL)
    assert cfg.swa_window == W
    api = ref_build_model(cfg)
    dense = jax.tree.map(np.asarray, api.init_params(jax.random.key(5)))
    dense["embed"]["w"] = dense["embed"]["w"] * np.float32(0.05)
    packed = jax.tree.map(np.asarray, ref_convert(dense, squeeze=1,
                                                  backend="v3"))
    params = jax.tree.map(jnp.asarray, packed)
    with use_backend("xla"):
        prefill = jax.jit(lambda t, n: api.prefill(
            params, {"tokens": t}, s_max=S_MAX, plen=n))
        step = jax.jit(lambda t, c, p: api.decode_step(params, t, c, p))
    return dict(prefill=prefill, step=step, ref={},
                api=build_model(scale_down(ARCHS["gemma3-12b"], **SMALL),
                                device="cpu"),
                params=from_reference(packed, device="cpu"))


def _reference_tokens(m, req):
    """The engine's chunk schedule of one request on the reference model
    API: ``prefill`` of the first CHUNK tokens, then one ``decode_step``
    per remaining prompt token, then greedy ``decode_step``s (cached per
    prompt and length)."""
    p = np.asarray(req.prompt, np.int32)
    key = (p.tobytes(), req.max_new_tokens)
    if key in m["ref"]:
        return m["ref"][key]
    feed = min(len(p), CHUNK)
    toks = np.zeros((1, _prompt_bucket(feed, S_MAX)), np.int32)
    toks[0, :feed] = p[:feed]
    with use_backend("xla"):
        logits, caches = m["prefill"](jnp.asarray(toks),
                                      jnp.asarray([feed], jnp.int32))
        for pos in range(feed, len(p)):
            logits, caches = m["step"](jnp.asarray(p[None, pos:pos + 1]),
                                       caches, jnp.asarray([pos], jnp.int32))
        out, pos = [int(np.asarray(logits)[0].argmax())], len(p)
        while len(out) < req.max_new_tokens:
            logits, caches = m["step"](jnp.asarray([[out[-1]]], jnp.int32),
                                       caches, jnp.asarray([pos], jnp.int32))
            out.append(int(np.asarray(logits)[0].argmax()))
            pos += 1
    m["ref"][key] = out
    return out


def _requests():
    """A (24 tokens), C (30) and B (A's first 16 tokens + 6): B reuses A's
    snapshot at 16 (whose rings hold positions 8..15, wrapped once)."""
    rng = np.random.default_rng(9)
    a = rng.integers(0, 256, 24)
    return [Request(rid=0, prompt=a, max_new_tokens=10),
            Request(rid=1, prompt=rng.integers(0, 256, 30),
                    max_new_tokens=8),
            Request(rid=2, prompt=np.concatenate(
                [a[:16], rng.integers(0, 256, 6)]), max_new_tokens=10)]


def _engine(m, slots=2, **kw):
    kw.setdefault("chunk_len", CHUNK)
    return ServeEngine(m["api"], m["params"], slots=slots, s_max=S_MAX,
                       device="cpu", backend="v3", **kw)


def _serve(eng):
    """A and C together, then B (a prefix hit where the cache is on)."""
    reqs = _requests()
    eng.run(reqs[:2], max_steps=200)
    eng.run(reqs[2:], max_steps=200)
    assert all(r.outcome == "completed" for r in reqs)
    return [r.out_tokens for r in reqs]


def test_leaves_classified_rings_side_global_paged(m):
    eng = _engine(m)
    assert eng._paged == [{"k": False, "v": False}] * 5 \
        + [{"k": True, "v": True}]
    assert [c["k"].shape[1] for c in eng.caches] == [W] * 5 + [S_MAX]


@pytest.mark.parametrize("kw", [
    dict(), dict(prefix_cache=True, page_tokens=8),
    dict(spec_depth=2), dict(spec_depth=2, prefix_cache=True,
                             page_tokens=8)],
    ids=["chunked", "prefix", "spec", "spec+prefix"])
def test_engine_tokens_match_reference_loop(m, kw):
    eng = _engine(m, **kw)
    got = _serve(eng)
    assert got == [_reference_tokens(m, r) for r in _requests()]
    if kw.get("prefix_cache"):
        assert eng._m["prefix_hits"].value >= 1
        assert eng._m["prefix_side_rows"].value \
            == eng._m["prefix_snapshots"].value > 0
    if kw.get("spec_depth"):
        assert eng._m["spec_rounds"].value > 0


def test_spec_equals_no_spec_past_the_window(m):
    """Rows decode 12-16 tokens past prompts of 20-27, far past W; drafting
    at depth 1 (mostly wrong drafts, so verify reads rings right after a
    draft) gives the non-speculative tokens."""
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 256, n) for n in (20, 27, 23)]

    def run(**kw):
        reqs = [Request(rid=i, prompt=p, max_new_tokens=12 + 2 * i)
                for i, p in enumerate(prompts)]
        eng = _engine(m, slots=3, **kw)
        eng.run(reqs, max_steps=300)
        return [r.out_tokens for r in reqs], eng
    plain, _ = run()
    spec, eng = run(spec_depth=1)
    assert eng._m["spec_rounds"].value > 0
    assert eng._m["spec_rolled_back"].value > 0
    assert spec == plain


def test_draft_leaves_rings_and_read_positions_untouched(m):
    """One draft pass past W: every ring leaf is bitwise what it was, and
    the full-length leaf is unchanged at every position a row has."""
    eng = _engine(m, slots=2, spec_depth=1)
    for r in _requests()[:2]:
        eng.submit(r)
    while any(eng._prefilling(i) or eng.active[i] is None
              for i in range(2)) or min(eng.pos) <= W:
        eng.pump()
        eng.step()
    before = [{k: t.clone() for k, t in c.items()} for c in eng.caches]
    rows = eng._spec_rows()
    assert rows.all()
    eng._draft(rows)
    for i, (b, c) in enumerate(zip(before, eng.caches)):
        for k in c:
            if eng._paged[i][k]:
                for r, p in enumerate(eng.pos):
                    assert torch.equal(b[k][r, :p], c[k][r, :p])
            else:
                assert torch.equal(b[k], c[k]), (i, k)


def test_prefix_hit_restores_the_cold_rings_bitwise(m):
    """B restored from A's snapshot at 16 holds, ring for ring, the bytes a
    cold admission of B has after scoring its first 16 tokens, and serves
    the cold tokens; one slot each, so both run the same schedule."""
    a, _, b = _requests()
    hot = _engine(m, slots=1, prefix_cache=True, page_tokens=8)
    hot.run([a], max_steps=100)
    hot.submit(b)
    hot.pump()
    assert hot._m["prefix_hits"].value == 1 and hot.pos[0] == 16
    ent = hot._prefix.lookup(np.asarray(b.prompt, np.int32), 21)
    restored = [{k: t[0].clone() for k, t in c.items()} for c in hot.caches]
    cold = _engine(m, slots=1)
    b2 = cold.submit(Request(rid=2, prompt=b.prompt, max_new_tokens=10))
    cold.pump()
    while cold._pf_next[0] < 16:
        cold.step()
    assert cold._pf_next[0] == 16
    for i, (r, c) in enumerate(zip(restored, cold.caches)):
        for k in r:
            if hot._paged[i][k]:
                assert torch.equal(r[k][:16], c[k][0, :16]), (i, k)
            else:
                assert torch.equal(r[k], c[k][0]), (i, k)
                assert torch.equal(hot._side[i][k][ent.entry_slot], r[k])
    while not b.done:
        hot.step()
    while not b2.done:
        cold.step()
    assert b.out_tokens == b2.out_tokens


def test_unclassifiable_leaf_serves_without_the_prefix_cache(m):
    """A leaf that is neither paged nor side (here one whose sequence dim
    the probe at 2 * s_max sees grow 6x) turns the prefix cache off, as in
    the reference; the engine serves the reference's tokens without it."""
    api = m["api"]
    real = api.init_cache

    def odd(batch, s_max, device=None):
        caches = real(batch, s_max, device=device)
        if s_max != S_MAX:
            k = caches[-1]["k"]
            caches[-1]["k"] = torch.zeros(
                (batch, 3 * s_max) + tuple(k.shape[2:]), device=k.device)
        return caches
    api.init_cache = odd
    try:
        eng = _engine(m, prefix_cache=True, page_tokens=8)
    finally:
        del api.init_cache
    assert eng._paged is None and eng._prefix is None
    assert _serve(eng) == [_reference_tokens(m, r) for r in _requests()]
