"""llava-next-34b's vision stub in the port against the reference, at
``scale_down(d_model=128, d_ff=256, head_dim=32, n_heads=4, vocab=256,
dtype="float32")`` (8 frontend tokens): the one-shot model API with seeded
``patches``, dense, and with ``patch_proj`` packed (the reference cannot
prefill that tree, ROADMAP R5, so it runs on the tree with ``patch_proj``
dequantized); then the engine's frontend branch: whole-prompt admission
(no chunked steps, no prefix cache), ``plen`` and positions counting the
frontend tokens, ``PromptTooLong`` at ``len + 8 >= s_max``, and tokens
equal to the reference model-API loop on zero bf16 patches.

Tolerance: 1e-5 of the logits' max |value| (f32 on both sides)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backend import use_backend
from repro_torch.serve import PromptTooLong, Request, ServeEngine
from repro_torch.serve.engine import _prompt_bucket

from _torch_small import dequantized, family_models

ARCH = "llava-next-34b"
OVER = dict(d_model=128, d_ff=256, head_dim=32, n_heads=4, vocab=256,
            dtype="float32")
S_MAX, LENS, N_NEW, FRONT = 48, (13, 7), 3, 8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def m():
    return family_models(ARCH, **OVER)


def _close(port, ref, tol=1e-5):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    err = np.abs(port - ref).max() / np.abs(ref).max()
    assert err <= tol, err


def _batch(patches=True):
    rng = np.random.default_rng(15)
    toks = rng.integers(0, 256, (2, max(LENS)))
    for i, n in enumerate(LENS):
        toks[i, n:] = 0
    p = rng.standard_normal((2, FRONT, 128)).astype(np.float32) \
        if patches else np.zeros((2, FRONT, 128), np.float32)
    return toks, p


def _reference_loop(m, params, patches):
    prefill = jax.jit(lambda p, b, n: m.api.prefill(p, b, s_max=S_MAX,
                                                    plen=n))
    step = jax.jit(m.api.decode_step)
    toks, _ = _batch()
    params = jax.tree.map(jnp.asarray, params)
    plen = np.array(LENS) + FRONT
    with use_backend("xla"):
        logits, caches = prefill(params, {
            "tokens": jnp.asarray(toks, jnp.int32),
            "patches": jnp.asarray(patches)}, jnp.asarray(plen, jnp.int32))
        out, pos = [np.asarray(logits)], plen
        for _ in range(N_NEW):
            tok = out[-1].argmax(-1).astype(np.int32)[:, None]
            logits, caches = step(params, jnp.asarray(tok), caches,
                                  jnp.asarray(pos, jnp.int32))
            out.append(np.asarray(logits))
            pos = pos + 1
    return out


@pytest.mark.parametrize("backend", ["dense", "v2", "v3"])
def test_one_shot_with_patches_matches_reference(m, backend):
    """Seeded patches through ``patch_proj``; packed (R5), ``patch_proj``
    dispatches through ``sme_apply`` and the reference runs on its
    dequantized weight."""
    toks, patches = _batch()
    if backend == "dense":
        ref = _reference_loop(m, m.dense, patches)
        params = m.port_dense
    else:
        assert isinstance(m.packed["patch_proj"]["w"], dict)
        ref = _reference_loop(m, dequantized(m.packed, "patch_proj", "w"),
                              patches)
        params = m.port_packed
    api = m.port_api
    logits, caches = api.prefill(params, toks, s_max=S_MAX,
                                 plen=np.array(LENS) + FRONT,
                                 backend=None if backend == "dense"
                                 else backend, patches=patches)
    pos = np.array(LENS) + FRONT
    for step, r in enumerate(ref):
        _close(logits.numpy(), r)
        tok = logits.argmax(-1)
        assert np.array_equal(tok.numpy(), r.argmax(-1)), step
        if step < N_NEW:
            logits, caches = api.decode_step(
                params, tok[:, None], caches, pos,
                backend=None if backend == "dense" else backend)
            pos = pos + 1


def test_reference_cannot_prefill_a_packed_patch_proj(m):
    toks, patches = _batch()
    with use_backend("xla"), pytest.raises(AttributeError):
        m.api.prefill(jax.tree.map(jnp.asarray, m.packed), {
            "tokens": jnp.asarray(toks, jnp.int32),
            "patches": jnp.asarray(patches)}, s_max=S_MAX)


def test_engine_admits_whole_prompts_behind_the_frontend(m):
    """Prompts longer than ``chunk_len`` are still admitted whole: no
    chunked step, no prefix cache; each slot's position counts the 8
    frontend tokens; tokens equal the reference loop on zero patches
    (bf16 zeros, as the reference engine feeds); ``PromptTooLong`` at
    ``len + 8 >= s_max``."""
    reqs = [Request(rid=i, prompt=np.random.default_rng(30 + i).integers(
        0, 256, n), max_new_tokens=N_NEW + 1) for i, n in enumerate(LENS)]
    eng = ServeEngine(m.port_api, m.port_packed, slots=2, s_max=S_MAX,
                      chunk_len=4, prefix_cache=True, device="cpu",
                      backend="v2")
    assert eng._prefix is None and eng._c == S_MAX
    eng.submit(reqs[0])
    eng.submit(reqs[1])
    eng.pump()
    assert [int(p) for p in eng.pos] == [n + FRONT for n in LENS]
    stats = eng.run([], max_steps=20)
    assert all(r.done and len(r.out_tokens) == N_NEW + 1 for r in reqs)
    assert stats["prefills"] == 1 and eng.step_ms()["chunked"][0] == 0
    tree = dequantized(m.packed, "patch_proj", "w")
    toks = np.zeros((2, _prompt_bucket(max(LENS), S_MAX)), np.int64)
    for i, r in enumerate(reqs):
        toks[i, :len(r.prompt)] = r.prompt
    ref = _engine_reference(m, tree, toks)
    assert [r.out_tokens for r in reqs] == ref
    for n, ok in ((S_MAX - FRONT - 1, True), (S_MAX - FRONT, False)):
        req = Request(rid=9, prompt=np.zeros(n, np.int64), max_new_tokens=1)
        if ok:
            assert eng.add_request(req)
        else:
            with pytest.raises(PromptTooLong, match="8 frontend tokens"):
                eng.add_request(req)


def _engine_reference(m, tree, toks):
    params = jax.tree.map(jnp.asarray, tree)
    plen = np.array(LENS) + FRONT
    with use_backend("xla"):
        logits, caches = m.api.prefill(params, {
            "tokens": jnp.asarray(toks, jnp.int32),
            "patches": jnp.zeros((2, FRONT, 128), jnp.bfloat16)},
            s_max=S_MAX, plen=jnp.asarray(plen, jnp.int32))
        out = [[int(t)] for t in np.asarray(logits).argmax(-1)]
        step = jax.jit(m.api.decode_step)
        pos = plen
        for _ in range(N_NEW):
            tok = np.array([[o[-1]] for o in out], np.int32)
            logits, caches = step(params, jnp.asarray(tok), caches,
                                  jnp.asarray(pos, jnp.int32))
            for o, t in zip(out, np.asarray(logits).argmax(-1)):
                o.append(int(t))
            pos = pos + 1
    return out
