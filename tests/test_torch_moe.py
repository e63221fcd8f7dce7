"""The port's MoE MLP (``models/moe.py``) against the reference's
``moe_apply``, for mixtral-8x7b (4 experts top-2 at this size) and
deepseek-v2-lite-16b (4 experts top-2 and 2 shared experts) at
``scale_down(d_model=128, expert_dff=128, dtype="float32")``, on the same
numpy inputs: dense, and packed under v1, v2 and v3 (the kernels' plain
versions on the CPU; the reference on its ``xla`` backend), a ragged
``plen`` batch whose capacity drops are non-empty, groups shorter than the
sequence, a three-way tie in the router, and per-expert draft depths under
``use_spec_depth("plan")``; then the engine's tokens for both models
against the reference model-API loop on the engine's own schedule.

Tolerance: 5e-5 of the output's max |value| (f32 on both sides, summed in
different orders); across v1, v2 and v3 the port's results are bitwise
equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backend import use_backend
from repro.models.moe import moe_apply as ref_moe_apply
from repro_torch.core.backend import (sme_apply, smeweight_from_param,
                                      use_spec_depth)
from repro_torch.models.moe import moe_apply, moe_capacity, moe_drops
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.engine import _prompt_bucket

from _torch_small import family_models

OVER = dict(d_model=128, expert_dff=128, dtype="float32")
ARCH = ("mixtral-8x7b", "deepseek-v2-lite-16b")
TOL = 5e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mlp(m, packed):
    """The MoE layer's params: (reference numpy, port torch)."""
    ref = jax.tree.map(lambda a: a[0], (m.packed if packed else m.dense)
                       ["blocks"]["slot0"]["mlp"])
    port = (m.port_packed if packed else m.port_dense)["blocks"][0]["mlp"]
    return ref, port


def _x(shape, seed=5):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ref(p, x, cfg, **kw):
    with use_backend("xla"):
        return np.asarray(ref_moe_apply(jax.tree.map(jnp.asarray, p),
                                        jnp.asarray(x), cfg, **kw))


def _close(port, ref, tol=TOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    err = np.abs(port - ref).max() / np.abs(ref).max()
    assert err <= tol, err


def test_capacity_and_config():
    m = family_models("deepseek-v2-lite-16b", **OVER)
    cfg = m.port_api.cfg
    assert (cfg.n_experts, cfg.top_k, cfg.n_shared_experts,
            cfg.expert_dff, cfg.first_dense_layers, cfg.n_super) == \
        (4, 2, 2, 128, 1, 1)
    assert [moe_capacity(s, cfg) for s in (1, 7, 24, 2048)] == \
        [1, 5, 15, 1280]


@pytest.mark.parametrize("arch", ARCH)
@pytest.mark.parametrize("backend", ["dense", "v1", "v2", "v3"])
def test_moe_apply_matches_reference(arch, backend):
    m = family_models(arch, **OVER)
    ref_p, p = _mlp(m, backend != "dense")
    x = _x((2, 24, 128))
    ref = _ref(ref_p, x, m.cfg)
    got = moe_apply(p, torch.as_tensor(x), m.port_api.cfg,
                    backend=None if backend == "dense" else backend)
    assert got.shape == (2, 24, 128)
    _close(got.numpy(), ref)
    if backend != "dense":
        assert isinstance(p["wi"], dict) and p["wi"]["sme_codes"].shape[0] \
            == m.cfg.n_experts


@pytest.mark.parametrize("arch", ARCH)
def test_backends_bitwise_and_decode_rows(arch):
    """v1, v2 and v3 bitwise equal on a prefill and on a decode batch (S =
    1, capacity 1, every row its own group), and each decode row equals
    the same row run alone."""
    m = family_models(arch, **OVER)
    _, p = _mlp(m, True)
    cfg = m.port_api.cfg
    for shape in ((2, 24, 128), (4, 1, 128)):
        x = torch.as_tensor(_x(shape, 6))
        ys = [moe_apply(p, x, cfg, backend=b) for b in ("v1", "v2", "v3")]
        assert torch.equal(ys[0], ys[1]) and torch.equal(ys[0], ys[2])
    solo = torch.cat([moe_apply(p, x[i:i + 1], cfg, backend="v3")
                      for i in range(4)])
    assert torch.equal(solo, ys[2])


def _skewed(ref_p, p, col=0, scale=40.0):
    """Router params that send most tokens to expert ``col``."""
    ref_p = dict(ref_p, router={"w": ref_p["router"]["w"].copy()})
    ref_p["router"]["w"][:, col] += np.float32(scale / 128)
    p = dict(p, router={"w": torch.as_tensor(ref_p["router"]["w"])})
    return ref_p, p


@pytest.mark.parametrize("arch", ARCH)
def test_ragged_plen_drops_match_reference(arch):
    """A skewed router overflows expert 0: the drops are non-empty, and the
    valid rows equal the reference's with the same ``plen``."""
    m = family_models(arch, **OVER)
    ref_p, p = _skewed(*_mlp(m, True))
    x = _x((2, 24, 128), 7)
    x[:, :, :] += np.float32(1.0)       # a shared direction for the skew
    plen = np.array([24, 9])
    ref = _ref(ref_p, x, m.cfg, plen=jnp.asarray(plen, jnp.int32))
    moe_drops.update(dropped=0, routed=0)
    got = moe_apply(p, torch.as_tensor(x), m.port_api.cfg,
                    plen=torch.as_tensor(plen), backend="v2").numpy()
    assert int(moe_drops["dropped"]) > 0
    assert int(moe_drops["routed"]) == (24 + 9) * m.cfg.top_k
    for i, n in enumerate(plen):
        _close(got[i, :n], ref[i, :n])


@pytest.mark.parametrize("arch", ARCH)
def test_groups_shorter_than_the_sequence(arch):
    """``group_size`` 8 over 20 tokens: three groups per row, the last one
    padded, each with its own capacity and threshold."""
    m = family_models(arch, **OVER)
    ref_p, p = _skewed(*_mlp(m, False), col=1, scale=20.0)
    x = _x((2, 20, 128), 8)
    plen = np.array([20, 13])
    ref = _ref(ref_p, x, m.cfg, group_size=8,
               plen=jnp.asarray(plen, jnp.int32))
    got = moe_apply(p, torch.as_tensor(x), m.port_api.cfg, group_size=8,
                    plen=torch.as_tensor(plen)).numpy()
    for i, n in enumerate(plen):
        _close(got[i, :n], ref[i, :n])


def test_router_tie_takes_the_lower_experts():
    """Router columns 1, 2 and 3 equal and dominant: top-2 must take
    experts 1 and 2 (the lower indices), as ``jax.lax.top_k`` does."""
    m = family_models("mixtral-8x7b", **OVER)
    ref_p, p = _mlp(m, False)
    w = ref_p["router"]["w"].copy()
    w[:, 2] = w[:, 3] = w[:, 1] = w[:, 1] + np.float32(0.5)
    ref_p = dict(ref_p, router={"w": w})
    p = dict(p, router={"w": torch.as_tensor(w)})
    x = np.abs(_x((1, 6, 128), 9))
    ref = _ref(ref_p, x, m.cfg)
    got = moe_apply(p, torch.as_tensor(x), m.port_api.cfg).numpy()
    _close(got, ref)
    # expert 3 never ran: zeroing it changes nothing
    p3 = dict(p, wi=p["wi"].clone())
    p3["wi"][3] = 0
    assert np.array_equal(moe_apply(p3, torch.as_tensor(x),
                                    m.port_api.cfg).numpy(), got)


def test_per_expert_draft_depths():
    """Each expert's ``sme_draft_planes`` under ``use_spec_depth("plan")``:
    v3 truncates expert ``e`` to its own depth (equal to a call on that
    expert alone at that depth, and within tolerance of its top-planes
    oracle), v1 and v2 stay exact; the MoE output under the plan equals
    one on the dense top-planes experts."""
    m = family_models("mixtral-8x7b", **OVER)
    _, p = _mlp(m, True)
    depths = torch.tensor([1, 2, 3, 8], dtype=torch.int32)
    p = {k: (dict(v, sme_draft_planes=depths) if k in ("wi", "wg", "wo")
             else v) for k, v in p.items()}
    h = torch.as_tensor(_x((4, 3, 128), 10))
    with use_spec_depth("plan"):
        got = sme_apply(h, p["wi"], "v3")
        exact = sme_apply(h, p["wi"], "v2")
    full = sme_apply(h, p["wi"], "v3")
    assert torch.equal(exact, full) and not torch.equal(got, full)
    host = {k: v.numpy() for k, v in p["wi"].items()}
    for e, d in enumerate(depths.tolist()):
        one = {k: (v[e] if v.dim() and v.shape[0] == 4 else v)
               for k, v in p["wi"].items() if k != "sme_draft_planes"}
        assert torch.equal(got[e], sme_apply(h[e], one, "v3",
                                             plane_depth=d))
        w = smeweight_from_param(host, (e,)).dequant_topk_planes(d)
        _close(got[e].numpy(), h[e].numpy().astype(np.float64) @ w)
    cfg = m.port_api.cfg
    x = torch.as_tensor(_x((2, 8, 128), 11))
    trunc = {k: torch.stack([torch.as_tensor(smeweight_from_param(
        {kk: vv.numpy() for kk, vv in p[k].items()}, (e,))
        .dequant_topk_planes(int(d)), dtype=torch.float32)
        for e, d in enumerate(depths)]) for k in ("wi", "wg", "wo")}
    with use_spec_depth("plan"):
        drafted = moe_apply(p, x, cfg, backend="v3")
    _close(drafted.numpy(), moe_apply({**p, **trunc}, x, cfg).numpy())


# ------------------------------------------------------------- the engine
S_MAX, CHUNK = 48, 8


def _reference_tokens(m, req, chunk=CHUNK):
    """The engine's schedule on the reference model API (jitted, ``xla``):
    ``prefill`` of the first ``chunk`` tokens with ``plen``, then one
    ``decode_step`` per tail token and per greedy token."""
    params = jax.tree.map(jnp.asarray, m.dense)
    p = np.asarray(req.prompt, np.int32)
    feed = min(len(p), chunk)
    toks = np.zeros((1, _prompt_bucket(feed, S_MAX)), np.int32)
    toks[0, :feed] = p[:feed]
    step = m.step
    with use_backend("xla"):
        logits, caches = m.prefill(params, jnp.asarray(toks),
                                   jnp.asarray([feed], jnp.int32))
        last, pos = np.asarray(logits)[0], feed
        while pos < len(p):
            lg, caches = step(params, jnp.asarray([[p[pos]]]), caches,
                              jnp.asarray([pos], jnp.int32))
            last, pos = np.asarray(lg)[0], pos + 1
        out = [int(last.argmax())]
        while len(out) < req.max_new_tokens:
            lg, caches = step(params, jnp.asarray([[out[-1]]], jnp.int32),
                              caches, jnp.asarray([pos], jnp.int32))
            out.append(int(np.asarray(lg).argmax()))
            pos += 1
    return out


@pytest.mark.parametrize("arch", ARCH)
def test_engine_tokens_match_reference_loop(arch):
    """Chunked prefill (chunk 8), ragged slots, dense; then the packed
    model under v3 with spec at depth 2 serves the same requests to the
    same tokens as without spec."""
    m = family_models(arch, **OVER)
    m.prefill = jax.jit(lambda p, t, n: m.api.prefill(
        p, {"tokens": t}, s_max=S_MAX, plen=n))
    m.step = jax.jit(m.api.decode_step)

    def reqs():
        return [Request(rid=i, prompt=np.random.default_rng(20 + i)
                        .integers(0, 256, n), max_new_tokens=4)
                for i, n in enumerate((13, 6, 19))]
    dense = reqs()
    eng = ServeEngine(m.port_api, m.port_dense, slots=2, s_max=S_MAX,
                      chunk_len=CHUNK, device="cpu")
    assert eng.run(dense, max_steps=100)["completed"] == 3
    assert eng.step_ms()["chunked"][0] > 0
    for r in dense:
        assert r.out_tokens == _reference_tokens(m, r), r.rid
    runs = []
    for spec in (None, 2):
        rs = reqs()
        ServeEngine(m.port_api, m.port_packed, slots=2, s_max=S_MAX,
                    chunk_len=CHUNK, device="cpu", backend="v3",
                    spec_depth=spec).run(rs, max_steps=100)
        runs.append([r.out_tokens for r in rs])
    assert runs[0] == runs[1] and all(len(t) == 4 for t in runs[0])
