"""whisper-medium through the port's engine, launchers and artifacts, at
the size of ``test_torch_encdec.py`` (2 encoder and 2 decoder layers, 128
wide, f32, 8 frontend tokens from ``scale_down``).

The engine serves the reference model-API loop's tokens (``prefill`` on
the request's own zero frames, ``max(len(prompt), 2)`` of them, then
``decode_step`` from ``pos = len(prompt)``), with self-speculative decode
and without: the reference engine cannot be run (ROADMAP R1) and would
differ (R6, R8).  Then each reference gap: R6, a slot that an earlier,
longer request used serves a fresh engine's tokens, and on the
reference's own functions a cross cache zero-padded to ``s_max`` changes
the logits; R7, the reference cannot prefill a packed head; R8, decode
starts at ``len(prompt)``, not past the audio stub's frontend tokens.
Last, the launcher (``--arch whisper-medium``) and a reference-compiled
``.smez`` booted by ``ServeEngine.from_artifact``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler import compile_model as ref_compile
from repro.compiler import load_artifact as ref_load
from repro.core.backend import use_backend
from repro_torch.launch import compile as pcompile, serve as pserve
from repro_torch.serve import Request, ServeEngine

from _torch_small import dequantized, family_models

ARCH = "whisper-medium"
WHISPER = dict(d_model=128, d_ff=256, head_dim=32, n_heads=4, n_kv_heads=4,
               vocab=256, n_layers=2, dtype="float32")
S_MAX = 32
N_NEW = 5
#: prompt lengths: three requests for two slots (the third reuses a slot)
LENS = (9, 14, 5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models():
    m = family_models(ARCH, **WHISPER)
    if not hasattr(m, "prefill"):
        m.prefill = jax.jit(lambda p, t, f: m.api.prefill(
            p, {"tokens": t, "frames": f}, s_max=S_MAX))
        m.step = jax.jit(m.api.decode_step)
    return m


def _ref_params(m, tree=None):
    """The reference's packed tree with its head dequantized (R7)."""
    return jax.tree.map(jnp.asarray,
                        dequantized(m.packed if tree is None else tree,
                                    "lm_head", "w"))


def _frames(n):
    return np.zeros((1, max(n, 2), 128), np.float32)


def _reference_tokens(m, params, prompt, n_new=N_NEW):
    """The reference model-API loop for one request."""
    p = np.asarray(prompt, np.int32)[None]
    with use_backend("xla"):
        logits, caches = m.prefill(params, jnp.asarray(p),
                                   jnp.asarray(_frames(p.shape[1])))
        out = [int(np.asarray(logits)[0].argmax())]
        for i in range(n_new - 1):
            logits, caches = m.step(params, jnp.asarray([[out[-1]]],
                                                        jnp.int32),
                                    caches, jnp.asarray([p.shape[1] + i],
                                                        jnp.int32))
            out.append(int(np.asarray(logits)[0].argmax()))
    return out


def _prompts(lens=LENS, seed=21):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n) for n in lens]


def _engine(m, slots=2, spec=None, **kw):
    return ServeEngine(m.port_api, m.port_packed, slots=slots, s_max=S_MAX,
                       backend="v3", spec_depth=spec, device="cpu", **kw)


def _serve(eng, prompts):
    reqs = [Request(rid=i, prompt=p, max_new_tokens=N_NEW)
            for i, p in enumerate(prompts)]
    stats = eng.run(reqs, max_steps=100)
    assert stats["completed"] == len(reqs)
    return [r.out_tokens for r in reqs]


@pytest.mark.parametrize("spec", [None, 2])
def test_engine_tokens_match_reference_loop(spec):
    """Three requests for two slots (one request per admission window;
    the third reuses a slot), v3, with a draft at depth 2 and without:
    every request gets the reference loop's tokens."""
    m = _models()
    eng = _engine(m, spec=spec)
    got = _serve(eng, _prompts())
    assert eng.stats["prefills"] == eng.stats["prefill_reqs"] == len(LENS)
    assert (eng._m["spec_rounds"].value > 0) == (spec is not None)
    params = _ref_params(m)
    assert got == [_reference_tokens(m, params, p) for p in _prompts()]


def test_cache_leaves_paged_and_the_draft_copies_none():
    """Self and cross K/V span ``s_max``: all paged, so a draft copies no
    leaf; the cross K/V are only read, so a spec step leaves them bitwise
    as they were."""
    m = _models()
    eng = _engine(m, spec=2)
    want = {"self/k": True, "self/v": True, "cross/k": True,
            "cross/v": True}
    assert eng._paged == [want, want]
    assert eng._prefix is None and not eng._chunk_prefill
    eng.submit(Request(rid=0, prompt=_prompts()[1], max_new_tokens=N_NEW))
    eng.pump()
    cross = [{k: c["cross"][k].clone() for k in "kv"} for c in eng.caches]
    clones = []
    real = torch.Tensor.clone

    def spy(t, *a, **kw):
        clones.append(tuple(t.shape))
        return real(t, *a, **kw)
    torch.Tensor.clone = spy
    try:
        eng._draft(np.array([True, False]))
    finally:
        torch.Tensor.clone = real
    assert not [s for s in clones if len(s) == 4]      # no cache leaf copied
    eng.step()
    assert eng._m["spec_rounds"].value == 1
    for c, was in zip(eng.caches, cross):
        for k in "kv":
            assert torch.equal(c["cross"][k], was[k])


def test_reused_slot_attends_only_its_own_source():
    """R6: one slot, a 20-token request then a 5-token one.  The second
    request's cross K/V fill 5 of the slot's 32 positions, over the first
    request's 20; it serves what it serves in a fresh engine, and the
    reference loop's tokens."""
    m = _models()
    long_, short = _prompts((20, 5), seed=22)
    eng = _engine(m, slots=1)
    got = _serve(eng, [long_, short])
    assert eng._src[0] == 5
    assert got[1] == _serve(_engine(m, slots=1), [short])[0]
    assert got[1] == _reference_tokens(m, _ref_params(m), short)


def test_reference_cross_cache_is_not_length_masked():
    """R6 on the reference's own functions: ``decode_step`` on the
    prefill's cross cache zero-padded to ``s_max`` (what the reference
    engine's slot holds) gives other logits than on the exact cache."""
    m = _models()
    params = _ref_params(m)
    prompt = _prompts()[0]
    with use_backend("xla"):
        logits, caches = m.prefill(params, jnp.asarray(prompt[None],
                                                       jnp.int32),
                                   jnp.asarray(_frames(len(prompt))))
        tok = jnp.asarray([[int(np.asarray(logits)[0].argmax())]], jnp.int32)
        pos = jnp.asarray([len(prompt)], jnp.int32)
        exact, _ = m.step(params, tok, caches, pos)
        pad = [(0, 0), (0, 0), (0, S_MAX - len(prompt)), (0, 0), (0, 0)]
        padded = {"self": caches["self"], "cross": jax.tree.map(
            lambda a: jnp.pad(a, pad), caches["cross"])}
        stale, _ = jax.jit(m.api.decode_step)(params, tok, padded, pos)
    exact, stale = np.asarray(exact), np.asarray(stale)
    assert np.abs(exact - stale).max() > 1e-2 * np.abs(exact).max()


def test_reference_cannot_prefill_a_packed_head():
    """R7: the reference's enc-dec head is ``x @ w``, so its prefill on
    converted params (``lm_head`` packed) raises; the port applies the
    packed head through ``sme_apply``."""
    m = _models()
    assert isinstance(m.packed["lm_head"]["w"], dict)
    toks = jnp.asarray(_prompts()[0][None], jnp.int32)
    with use_backend("xla"), pytest.raises(AttributeError):
        m.api.prefill(jax.tree.map(jnp.asarray, m.packed),
                      {"tokens": toks, "frames": jnp.asarray(_frames(9))},
                      s_max=S_MAX)
    logits, _ = m.port_api.prefill(m.port_packed, np.array(toks),
                                   s_max=S_MAX, frames=_frames(9),
                                   backend="v2")
    assert logits.shape == (1, 256) and bool(torch.isfinite(logits).all())


def test_decode_starts_at_the_prompt_length():
    """R8: ``scale_down`` gives the audio stub 8 frontend tokens, which the
    reference engine adds to the first decoder position; the port's
    engine starts decode at ``len(prompt)``, as the model-API loop does,
    and so serves its tokens."""
    m = _models()
    assert m.port_api.cfg.n_frontend_tokens == 8
    prompt = _prompts()[1]
    eng = _engine(m, slots=1)
    req = eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=N_NEW))
    eng.pump()
    assert eng.pos[0] == len(prompt) and eng._src[0] == len(prompt)
    while not req.done:
        eng.step()
    assert req.out_tokens == _reference_tokens(m, _ref_params(m), prompt)


# ------------------------------------------------- launchers and artifacts
def test_launchers_serve_and_compile_whisper(tmp_path, capsys):
    """``--arch whisper-medium`` serves at test size (v2, and v3 with a
    draft), and compiles to a ``.smez`` that the launcher boots."""
    for argv in (["--sme", "--backend", "v2"],
                 ["--sme", "--backend", "v3", "--spec-depth", "2"]):
        stats = pserve.main(["--arch", ARCH, "--small", "--device", "cpu",
                             "--requests", "3", "--max-new", "3", *argv])
        assert stats["completed"] == 3 and stats["backend"] == argv[2]
    out = tmp_path / "whisper.smez"
    plan = pcompile.main(["--arch", ARCH, "--small", "--out", str(out),
                          "--backend", "v3"])
    assert "dec/cross/q/w" in plan.layers
    stats = pserve.main(["--arch", ARCH, "--small", "--device", "cpu",
                         "--artifact", str(out), "--requests", "2",
                         "--max-new", "3"])
    assert stats["completed"] == 2 and stats["backend"] == "v3"
    assert "booted from" in capsys.readouterr().out


def test_reference_artifact_serves_reference_tokens(tmp_path):
    """A reference-compiled whisper ``.smez`` (v3; ``enc``/``dec`` stacked,
    the head packed) boots through ``from_artifact`` and serves the
    reference model-API loop's tokens on the artifact's weights."""
    m = _models()
    path = tmp_path / "whisper.smez"
    ref_compile(m.dense, out=path, backend="v3", error_budget=0.06,
                extra={"arch": ARCH, "config": "small",
                       "serve_backend": "auto"})
    tree, plan, _ = ref_load(path)
    assert {"enc/attn/q/w", "dec/cross/v/w", "lm_head/w"} <= set(plan.layers)
    eng = ServeEngine.from_artifact(m.port_api, path, slots=2, s_max=S_MAX,
                                    device="cpu")
    assert eng.stats["backend"] == "v3" and len(eng.params["dec"]) == 2
    params = _ref_params(m, jax.tree.map(np.asarray, tree))
    assert _serve(eng, _prompts()) == \
        [_reference_tokens(m, params, p) for p in _prompts()]
