"""The encoder-decoder family in the port against the reference:
whisper-medium at ``scale_down(d_model=128, d_ff=256, head_dim=32,
n_heads=4, n_kv_heads=4, vocab=256, n_layers=2, dtype="float32")`` (2
encoder and 2 decoder layers; the reference's ``scale_down`` alone would
give 25 decoder layers, as it counts the encoder's 24 into ``n_layers``).

Module by module on seeded inputs: ``layernorm``, ``sinusoidal_pos``, the
bidirectional ``blockwise_attention``, ``cross_kv``/``cross_apply``/
``cross_decode``, ``encdec_encode``, ``encdec_prefill`` (logits and every
cache leaf) and ``encdec_decode_step``; then greedy tokens of the model
API, dense and packed (v1, v2, v3 through the kernels' plain versions),
against the reference model-API loop (jitted on its ``xla`` backend; a
packed run's reference holds the dequantized head, as the reference
cannot apply a packed one, ROADMAP R7); the param tree's round trip and
``CompilePlan.to_json()`` equal to the reference's; and a ragged head (N
not a multiple of 128) through v2 and v3 bitwise equal, against the
reference's v2 Pallas kernel in interpret mode (this file's one
interpret-mode call) and the f64 oracle.

Tolerance: 1e-5 of the reference's max |value| (f32 on both sides, sums
in different orders)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler import plan as RPL
from repro.configs import ARCHS as REF_ARCHS, scale_down as ref_scale_down
from repro.core.backend import sme_apply as ref_sme_apply, use_backend
from repro.core.integrate import convert_params_to_sme as ref_convert
from repro.models import attention as RATT, common as RCOM, encdec as RED
from repro_torch.compiler import plan as PPL
from repro_torch.configs import ARCHS, ModelConfig, scale_down
from repro_torch.convert import from_reference, to_reference
from repro_torch.core.backend import sme_apply, smeweight_from_param
from repro_torch.core.integrate import to_torch
from repro_torch.core.sme import sme_matmul_ref_np
from repro_torch.models import attention as ATT, common as COM, encdec as ED
from repro_torch.models.model import build_model

from _torch_small import dequantized, family_models

ARCH = "whisper-medium"
WHISPER = dict(d_model=128, d_ff=256, head_dim=32, n_heads=4, n_kv_heads=4,
               vocab=256, n_layers=2, dtype="float32")
TOL = 1e-5
S_MAX = 32
N_NEW = 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(port, ref, tol=TOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max() / np.abs(ref).max()
    assert err <= tol, err


def _models():
    m = family_models(ARCH, **WHISPER)
    if not hasattr(m, "prefill"):
        m.prefill = jax.jit(lambda p, t, f: m.api.prefill(
            p, {"tokens": t, "frames": f}, s_max=S_MAX))
        m.step = jax.jit(m.api.decode_step)
    return m


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _inputs(b=2, s=12, src=10, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, s)),
            rng.standard_normal((b, src, 128)).astype(np.float32))


# ----------------------------------------------------------------- configs
def test_config_matches_reference_and_builds():
    for port, ref in ((ARCHS[ARCH], REF_ARCHS[ARCH]),
                      (scale_down(ARCHS[ARCH], **WHISPER),
                       ref_scale_down(REF_ARCHS[ARCH], **WHISPER)),
                      (scale_down(ARCHS[ARCH]),
                       ref_scale_down(REF_ARCHS[ARCH]))):
        ref_d = dataclasses.asdict(ref)
        for f in dataclasses.fields(ModelConfig):
            assert getattr(port, f.name) == ref_d[f.name], f.name
    small = scale_down(ARCHS[ARCH], **WHISPER)
    assert (small.n_enc_layers, small.n_layers) == (2, 2)
    assert build_model(ARCHS[ARCH], device="cpu").encdec


# ------------------------------------------------------------------ modules
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_and_sinusoidal_pos(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 128)).astype(np.float32) * 3 + 1
    p = {"w": rng.standard_normal(128).astype(np.float32),
         "b": rng.standard_normal(128).astype(np.float32)}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    for kind, pp in (("layernorm", p), ("layernorm", {"w": p["w"]}),
                     ("rmsnorm", {"w": p["w"]})):
        ref = RCOM.apply_norm(jnp.asarray(x, jdt),
                              jax.tree.map(jnp.asarray, pp), kind)
        got = COM.apply_norm(_t(x).to(tdt), {k: _t(v) for k, v in pp.items()},
                             kind)
        assert got.dtype == tdt
        _close(got.float().numpy(), np.asarray(ref, np.float32),
               TOL if dtype == "float32" else 1e-2)
    pos = COM.sinusoidal_pos(37, 128)
    assert pos.dtype == torch.float32
    assert np.array_equal(pos.numpy(),
                          np.asarray(RCOM.sinusoidal_pos(37, 128)))


@pytest.mark.parametrize("block", [8, 512])
def test_bidirectional_blockwise_attention(block):
    """Every key attended (19 queries over 23 keys, GQA 4:2), in blocks
    of 8 (ragged last blocks) and in one block."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 19, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 23, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 23, 2, 32)).astype(np.float32)
    ref = RATT.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=False,
                                   block_q=block, block_k=block)
    got = ATT.blockwise_attention(_t(q), _t(k), _t(v), causal=False,
                                  block_q=block, block_k=block)
    _close(got.numpy(), ref)


def test_cross_attention_matches_reference():
    m = _models()
    cfg, pcfg = m.cfg, m.port_api.cfg
    ref_p = jax.tree.map(lambda a: jnp.asarray(a[0]), m.dense["dec"]["cross"])
    p = m.port_dense["dec"][0]["cross"]
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((2, 10, 128)).astype(np.float32)
    x = rng.standard_normal((2, 7, 128)).astype(np.float32)
    kv_r = RATT.cross_kv(ref_p, jnp.asarray(enc), cfg)
    kv = ATT.cross_kv(p, _t(enc), pcfg)
    for k in "kv":
        _close(kv[k].numpy(), kv_r[k])
    _close(ATT.cross_apply(p, _t(x), kv, pcfg, block_q=4,
                           block_k=4).numpy(),
           RATT.cross_apply(ref_p, jnp.asarray(x), kv_r, cfg, 4, 4))
    _close(ATT.cross_decode(p, _t(x[:, :1]), kv, pcfg).numpy(),
           RATT.cross_decode(ref_p, jnp.asarray(x[:, :1]), kv_r, cfg))


def test_encode_prefill_decode_match_reference():
    """The encoder's states, the prefill's logits and every cache leaf
    (self K/V over ``s_max`` slots, cross K/V over the 10 source
    positions), then one decode step's logits and self K/V."""
    m = _models()
    cfg, pcfg = m.cfg, m.port_api.cfg
    params = jax.tree.map(jnp.asarray, m.dense)
    toks, frames = _inputs()
    with use_backend("xla"):
        enc_r = RED.encdec_encode(params, jnp.asarray(frames), cfg)
        rl, rc = m.prefill(params, jnp.asarray(toks, jnp.int32),
                           jnp.asarray(frames))
    _close(ED.encdec_encode(m.port_dense, _t(frames), pcfg).numpy(), enc_r)
    pl, pc = ED.encdec_prefill(m.port_dense, _t(toks), _t(frames), pcfg,
                               S_MAX)
    _close(pl.numpy(), rl)
    assert len(pc) == 2
    for i, layer in enumerate(pc):
        for part, want in (("self", (2, S_MAX, 4, 32)),
                           ("cross", (2, 10, 4, 32))):
            for k in "kv":
                assert tuple(layer[part][k].shape) == want
                _close(layer[part][k].numpy(), rc[part][k][i])
    tok = pl.argmax(-1).numpy()[:, None]
    with use_backend("xla"):
        rl2, rc2 = m.step(params, jnp.asarray(tok, jnp.int32), rc,
                          jnp.asarray([12, 12], jnp.int32))
    pl2, pc2 = ED.encdec_decode_step(m.port_dense, _t(tok), pc,
                                     torch.tensor([12, 12]), pcfg)
    _close(pl2.numpy(), rl2)
    for i in range(2):
        for k in "kv":
            _close(pc2[i]["self"][k].numpy(), rc2["self"][k][i])


def _reference_loop(m, params, toks, frames):
    """Greedy logits of the reference model-API loop: prefill, then
    ``decode_step`` from ``pos = S``."""
    with use_backend("xla"):
        logits, caches = m.prefill(params, jnp.asarray(toks, jnp.int32),
                                   jnp.asarray(frames))
        out, pos = [np.asarray(logits)], toks.shape[1]
        for _ in range(N_NEW):
            tok = out[-1].argmax(-1).astype(np.int32)[:, None]
            logits, caches = m.step(params, jnp.asarray(tok), caches,
                                    jnp.asarray([pos] * len(toks),
                                                jnp.int32))
            out.append(np.asarray(logits))
            pos += 1
    return out


@pytest.mark.parametrize("backend", ["dense", "v1", "v2", "v3"])
def test_model_api_tokens_match_reference_loop(backend):
    """``ModelAPI.prefill`` (frames of another length than the tokens) and
    4 greedy ``decode_step``s: per-step logits within tolerance, equal
    tokens.  Packed: the port applies the packed head through
    ``sme_apply``, the reference its dequantized weight (R7)."""
    m = _models()
    toks, frames = _inputs()
    ref_params = jax.tree.map(jnp.asarray, m.dense if backend == "dense" else
                              dequantized(m.packed, "lm_head", "w"))
    ref = _reference_loop(m, ref_params, toks, frames)
    params = m.port_dense if backend == "dense" else m.port_packed
    be = None if backend == "dense" else backend
    api = m.port_api
    logits, caches = api.prefill(params, toks, s_max=S_MAX, frames=frames,
                                 backend=be)
    pos = np.full(2, toks.shape[1])
    for want in ref:
        _close(logits.numpy(), want)
        tok = logits.argmax(-1).numpy()
        assert np.array_equal(tok, want.argmax(-1))
        logits, caches = api.decode_step(params, tok[:, None], caches, pos,
                                         backend=be)
        pos = pos + 1


def test_model_api_refuses_ragged_or_frameless_prefill():
    m = _models()
    toks, frames = _inputs()
    for kw in ({}, {"frames": frames, "plen": [12, 9]}):
        with pytest.raises(ValueError, match="frames"):
            m.port_api.prefill(m.port_dense, toks, s_max=S_MAX, **kw)


# --------------------------------------------------- the tree and the plan
def test_convert_round_trip():
    """``from_reference`` splits the stacked ``enc``/``dec`` layers (packed
    leaves byte for byte); ``to_reference`` stacks them back."""
    m = _models()
    for tree in (m.dense, m.packed):
        port = from_reference(tree, device="cpu")
        assert len(port["enc"]) == len(port["dec"]) == 2
        back = to_reference(port)
        flat_a = jax.tree_util.tree_leaves_with_path(tree)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat_a) == len(flat_b)
        for path, a in flat_a:
            b = flat_b[path]
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes(), path
    with pytest.raises(NotImplementedError, match="enc, dec"):
        from_reference({**m.dense, "patch_proj": m.dense["lm_head"]},
                       device="cpu")


@pytest.mark.parametrize("backend", ["auto", "v3"])
def test_plan_matches_reference(backend):
    m = _models()
    ref = RPL.plan_model(m.dense, error_budget=0.06, backend=backend)
    port = PPL.plan_model(to_reference(from_reference(m.dense,
                                                      device="cpu")),
                          error_budget=0.06, backend=backend)
    assert port.to_json() == ref.to_json()
    assert {"lm_head/w", "enc/attn/q/w", "dec/cross/k/w",
            "dec/mlp/wo/w"} <= set(port.layers)


def test_ragged_head_is_exact():
    """A 128 x 300 head (2.3 column tiles): v2 and v3 bitwise equal at
    M = 4 (the decode batch) and M = 130, each within 5e-5 of the f64
    oracle and of the reference's v2 kernel in interpret mode."""
    w = np.random.default_rng(4).standard_normal((128, 300)).astype(
        np.float32) * np.float32(0.02)
    packed = jax.tree.map(np.asarray, ref_convert({"lm_head": {"w": w}},
                                                  squeeze=1, backend="all"))
    ref_head = packed["lm_head"]["w"]
    head = to_torch(ref_head, "cpu")
    smew = smeweight_from_param({k: v for k, v in ref_head.items()
                                 if not k.startswith("sme_v")})
    rng = np.random.default_rng(5)
    for m in (4, 130):
        x = rng.standard_normal((m, 128)).astype(np.float32)
        y2 = sme_apply(_t(x), head, "v2", out_dtype=torch.float32)
        y3 = sme_apply(_t(x), head, "v3", out_dtype=torch.float32)
        assert y2.shape == (m, 300) and torch.equal(y2, y3)
        _close(y2.numpy(), sme_matmul_ref_np(x, smew), 5e-5)
        if m == 4:
            ref = ref_sme_apply(jnp.asarray(x), jax.tree.map(jnp.asarray,
                                                             ref_head),
                                "v2", out_dtype=jnp.float32)
            _close(y2.numpy(), ref)
