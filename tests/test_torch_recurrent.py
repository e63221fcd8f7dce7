"""The recurrent family in the port against the reference: xlstm-1.3b (7
mLSTM + 1 sLSTM blocks, no MLP half) and jamba-v0.1-52b (7 Mamba slots, an
attention slot 4, MoE MLPs on odd slots) at the reference's SME-eligible
``scale_down(d_model=128, d_ff=256|0, vocab=256, expert_dff=128,
dtype="float32")``.

One-shot: a ragged prefill and greedy decode steps through the model API
give the reference model-API loop's logits and tokens, dense and packed
under v1, v2 and v3 (the kernels' plain versions; the reference jitted on
its ``xla`` backend).  The engine: Mamba's ``conv``/``h`` and every xLSTM
leaf are side leaves, Jamba's ``k``/``v`` paged; chunked prefill (chunk
8) with self-speculative decode and a prefix-cache hit serves the tokens
of a reference loop on the engine's schedule (a prefill of the first
chunk, then one ``decode_step`` per tail token: mLSTM's recurrent form
there, not its chunkwise form); a draft leaves
every side leaf bitwise as it was and every paged leaf below each row's
position.

Tolerance: logits within 1e-5 of the reference's max |logit| (f32 on both
sides; sums in different orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backend import use_backend
from repro_torch.configs import ARCHS, scale_down
from repro_torch.models.model import ModelAPI, build_model
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.engine import _prompt_bucket

from _torch_small import RECURRENT, family_models

ARCH = tuple(RECURRENT)
TOL = 1e-5
S_MAX, CHUNK, PAGE = 48, 8, 8
PLEN = (21, 6)
N_NEW = 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(port, ref, tol=TOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    err = np.abs(port - ref).max() / np.abs(ref).max()
    assert err <= tol, err


def _models(arch):
    m = family_models(arch, **RECURRENT[arch])
    if not hasattr(m, "prefill"):
        m.prefill = jax.jit(lambda p, t, n: m.api.prefill(
            p, {"tokens": t}, s_max=S_MAX, plen=n))
        m.step = jax.jit(m.api.decode_step)
    return m


def test_build_model_takes_the_recurrent_family():
    for arch in ARCH:
        api = build_model(scale_down(ARCHS[arch], **RECURRENT[arch]),
                          device="cpu")
        assert isinstance(api, ModelAPI)
        assert api.cfg.family == ("hybrid" if "jamba" in arch else "ssm")


@pytest.mark.parametrize("backend", ["dense", "v1", "v2", "v3"])
@pytest.mark.parametrize("arch", ARCH)
def test_one_shot_matches_reference_loop(arch, backend):
    """A ragged prefill (rows of 21 and 6 tokens) and 4 greedy decode
    steps: per-step logits within tolerance and equal tokens."""
    m = _models(arch)
    ref_params = jax.tree.map(jnp.asarray,
                              m.dense if backend == "dense" else m.packed)
    params = m.port_dense if backend == "dense" else m.port_packed
    be = None if backend == "dense" else backend
    toks = np.random.default_rng(11).integers(0, 256, (2, 32))
    for i, n in enumerate(PLEN):
        toks[i, n:] = 0
    with use_backend("xla"):
        rl, rc = m.prefill(ref_params, jnp.asarray(toks, jnp.int32),
                           jnp.asarray(PLEN, jnp.int32))
    pl, pc = m.port_api.prefill(params, toks, s_max=S_MAX, plen=PLEN,
                                backend=be)
    pos = np.array(PLEN)
    for _ in range(N_NEW):
        _close(pl.numpy(), rl)
        tok = pl.argmax(-1).numpy()
        assert np.array_equal(tok, np.asarray(rl).argmax(-1))
        with use_backend("xla"):
            rl, rc = m.step(ref_params, jnp.asarray(tok[:, None], jnp.int32),
                            rc, jnp.asarray(pos, jnp.int32))
        pl, pc = m.port_api.decode_step(params, tok[:, None], pc, pos,
                                        backend=be)
        pos = pos + 1
    _close(pl.numpy(), rl)


# ------------------------------------------------------------- the engine
def _requests():
    """Requests 0 and 2 share their first 16 tokens (two chunks)."""
    rng = np.random.default_rng(20)
    prompts = [rng.integers(0, 256, n) for n in (23, 6, 19)]
    prompts[2][:16] = prompts[0][:16]
    return [Request(rid=i, prompt=p, max_new_tokens=N_NEW)
            for i, p in enumerate(prompts)]


def _reference_tokens(m, params, req):
    """The engine's schedule on the reference model API: ``prefill`` of
    the first ``CHUNK`` tokens, then one ``decode_step`` per tail token and
    per greedy token."""
    p = np.asarray(req.prompt, np.int32)
    feed = min(len(p), CHUNK)
    toks = np.zeros((1, _prompt_bucket(feed, S_MAX)), np.int32)
    toks[0, :feed] = p[:feed]
    with use_backend("xla"):
        logits, caches = m.prefill(params, jnp.asarray(toks),
                                   jnp.asarray([feed], jnp.int32))
        last, pos = np.asarray(logits)[0], feed
        out = []
        while len(out) < req.max_new_tokens:
            if pos < len(p):
                tok = p[pos]
            else:
                out.append(int(last.argmax()))
                tok = out[-1]
            if len(out) == req.max_new_tokens:
                break
            lg, caches = m.step(params, jnp.asarray([[tok]], jnp.int32),
                                caches, jnp.asarray([pos], jnp.int32))
            last, pos = np.asarray(lg)[0], pos + 1
    return out


def _engine(m, spec, **kw):
    return ServeEngine(m.port_api, m.port_packed, slots=2, s_max=S_MAX,
                       chunk_len=CHUNK, page_tokens=PAGE, prefix_cache=True,
                       backend="v3", spec_depth=spec, device="cpu", **kw)


def _drive(eng, reqs):
    """Requests 0 and 1 first; request 2 once request 0 has scored the
    shared 16 tokens (so it hits their snapshot)."""
    a = reqs[0]
    for r in reqs[:2]:
        eng.submit(r)
    waiting = [reqs[2]]
    for _ in range(200):
        if all(r.done for r in reqs):
            return
        slot = next((i for i, r in enumerate(eng.active) if r is a), None)
        if waiting and (a.done or slot is not None
                        and eng._pf_next[slot] >= 16):
            eng.submit(waiting.pop())
        eng.pump()
        eng.step()
    raise AssertionError("engine did not finish")


@pytest.mark.parametrize("arch", ARCH)
def test_engine_tokens_match_reference_loop(arch):
    """Packed v3, chunked prefill, the prefix cache and spec at depth 2:
    the shared prefix hits, the engine drafts, and every request gets the
    reference loop's tokens (so spec changes no token)."""
    m = _models(arch)
    reqs = _requests()
    eng = _engine(m, 2)
    _drive(eng, reqs)
    assert eng._m["prefix_hits"].value >= 1
    assert eng._m["spec_rounds"].value > 0
    assert eng.step_ms()["chunked"][0] > 0
    params = jax.tree.map(jnp.asarray, m.packed)
    for r in reqs:
        assert r.out_tokens == _reference_tokens(m, params, r), r.rid


@pytest.mark.parametrize("arch", ARCH)
def test_cache_leaves_classified(arch):
    """Recurrent states are side leaves, attention K/V paged; an xLSTM
    model has no paged leaf, so its prefix pools are empty and a snapshot
    is side rows only."""
    m = _models(arch)
    eng = _engine(m, None)
    want = {"mamba": {"conv": False, "h": False},
            "attn": {"k": True, "v": True},
            "mlstm": {"C": False, "n": False, "m": False},
            "slstm": {"c": False, "n": False, "h": False, "m": False}}
    assert eng._paged == [want[k] for k in m.port_api.cfg.pattern]
    if arch == "xlstm-1.3b":
        assert all(pool == {} for pool in eng._pool)
    assert all(t.dtype == torch.float32 for layer in eng._side
               for name, t in layer.items() if name != "conv")


@pytest.mark.parametrize("arch", ARCH)
def test_draft_leaves_every_state_unchanged(arch):
    """After a draft of 4 steps, every side leaf is bitwise what it was
    and every paged leaf is unchanged below each row's position."""
    m = _models(arch)
    eng = _engine(m, 2)
    for r in _requests()[:2]:
        eng.submit(r)
    for _ in range(20):
        eng.pump()
        rows = eng._spec_rows()
        if rows.any():
            break
        eng.step()
    assert rows.any()
    before = [{k: t.clone() for k, t in layer.items()} for layer in eng.caches]
    eng._draft(rows)
    for layer, old, kinds in zip(eng.caches, before, eng._paged):
        for name, t in layer.items():
            if not kinds[name]:
                assert torch.equal(t, old[name]), name
                continue
            for i, p in enumerate(eng.pos):
                assert torch.equal(t[i, :p], old[name][i, :p]), name


def test_launcher_serves_xlstm_on_cpu():
    """``--arch xlstm-1.3b --small``: one superblock of 8 blocks, 128 wide
    and without an MLP half, packed for v3, through the engine with spec,
    chunking and the prefix cache."""
    from repro_torch.launch import serve
    stats = serve.main(["--arch", "xlstm-1.3b", "--small", "--device", "cpu",
                        "--sme", "--backend", "v3", "--spec-depth", "2",
                        "--chunk-len", "8", "--page-tokens", "8",
                        "--prefix-cache", "--requests", "3", "--max-new",
                        "3", "--slots", "2", "--s-max", "32"])
    assert stats["completed"] == 3 and stats["backend"] == "v3"


@pytest.mark.parametrize("arch", ARCH)
def test_convert_round_trips_packed_tree(arch):
    """``to_reference(n_slots=8)`` of the carried packed tree is the
    reference's byte for byte: 3-D and 4-D mixer leaves, dense gates and
    every packed projection."""
    from repro_torch.convert import to_reference
    m = _models(arch)
    back = to_reference(m.port_packed, n_slots=8)
    ra = jax.tree_util.tree_leaves_with_path(m.packed)
    pa = jax.tree_util.tree_leaves_with_path(back)
    assert [k for k, _ in ra] == [k for k, _ in pa]
    for (k, a), (_, b) in zip(ra, pa):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    assert back["blocks"]["slot7" if "xlstm" in arch else "slot0"]["mix"][
        "r" if "xlstm" in arch else "A_log"].shape[0] == 1
