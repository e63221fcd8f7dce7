"""The dense text family in the port against the reference: qwen2-0.5b (GQA
kv 2, tied head), phi4-mini-3.8b (untied head) and gemma3-12b (5:1
sliding-window local/global layers at W = 8, GELU MLPs, untied head) at
``scale_down(d_model=128, d_ff=256, head_dim=32, n_heads=4, n_kv_heads=2,
vocab=256, dtype="float32")``.

Configs equal the reference's field by field; prefill logits (ragged
``plen``, prompts of 24 tokens that wrap gemma's rings three times) and
greedy decode tokens equal the reference model-API loop on its ``xla``
backend, with the port serving the packed weights through the v2 and v3
kernels' plain versions; packed operands, ``lm_head`` included, are byte
for byte the reference's; ``from_reference``/``to_reference`` round-trip
over every superblock slot; gemma's ``CompilePlan.to_json()`` is the
reference's under ``auto`` and ``v3``.  One interpret-mode reference
kernel call checks the packed head's dispatch.

Tolerance: 1e-5 of the logits' max |value| (f32 on both sides, summed in
different orders: XLA's dense dequant-matmul against the kernels' plain
tile-group walks, einsum, softmax, rope; each op adds a few ulp)."""
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
from repro.models import build_model as ref_build_model
from repro_torch.compiler import plan as PPL
from repro_torch.configs import ARCHS, ModelConfig, scale_down
from repro_torch.convert import from_reference, to_reference
from repro_torch.core.backend import sme_apply
from repro_torch.core.integrate import _convert
from repro_torch.models.model import build_model

SMALL = dict(d_model=128, d_ff=256, head_dim=32, n_heads=4, n_kv_heads=2,
             vocab=256, dtype="float32")
FAMILY = ("qwen2-0.5b", "phi4-mini-3.8b", "gemma3-12b")
TOL = 1e-5
S_MAX = 32
PLEN = (24, 21)
N_NEW = 4
_MODELS = {}



@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: these models are tiny, and test workers that
    each spread tiny ops over every core slow each other down many
    times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def models(arch, n_super=1):
    """Reference config, API and params (dense, and packed for v1, v2 and
    v3 from one compression), and the port's API and params, per arch and
    depth in superblocks."""
    key = (arch, n_super)
    if key not in _MODELS:
        small = dict(SMALL, n_layers=n_super * len(REF_ARCHS[arch].pattern))
        cfg = ref_scale_down(REF_ARCHS[arch], **small)
        api = ref_build_model(cfg)
        dense = jax.tree.map(np.asarray, api.init_params(jax.random.key(3)))
        # a small embedding lets the layers, not the input token's echo,
        # pick the next token
        dense["embed"]["w"] = dense["embed"]["w"] * np.float32(0.05)
        packed = jax.tree.map(np.asarray, ref_convert(dense, squeeze=1,
                                                      backend="all"))
        _MODELS[key] = dict(
            cfg=cfg, api=api, dense=dense, packed=packed,
            port_api=build_model(scale_down(ARCHS[arch], **small),
                                 device="cpu"),
            port_packed=from_reference(packed, device="cpu"))
    return _MODELS[key]


def _close(port, ref, tol=TOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    err = np.abs(port - ref).max() / np.abs(ref).max()
    assert err <= tol, err


def _tokens():
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 256, (len(PLEN), max(PLEN)))
    for i, n in enumerate(PLEN):
        toks[i, n:] = 0
    return toks


def _reference_loop(m):
    """Ragged prefill, then greedy decode steps, on the reference model API
    (jitted, ``xla`` backend): per-step logits and tokens."""
    api, params = m["api"], jax.tree.map(jnp.asarray, m["packed"])
    prefill = jax.jit(lambda p, t, n: api.prefill(p, {"tokens": t},
                                                  s_max=S_MAX, plen=n))
    step = jax.jit(api.decode_step)
    with use_backend("xla"):
        logits, caches = prefill(params, jnp.asarray(_tokens(), jnp.int32),
                                 jnp.asarray(PLEN, jnp.int32))
        out, pos = [np.asarray(logits)], np.array(PLEN, np.int32)
        for _ in range(N_NEW):
            tok = out[-1].argmax(-1).astype(np.int32)[:, None]
            logits, caches = step(params, jnp.asarray(tok), caches,
                                  jnp.asarray(pos))
            out.append(np.asarray(logits))
            pos = pos + 1
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_config_matches_reference(arch):
    for port, ref in ((ARCHS[arch], REF_ARCHS[arch]),
                      (scale_down(ARCHS[arch], **SMALL),
                       ref_scale_down(REF_ARCHS[arch], **SMALL))):
        ref_d = dataclasses.asdict(ref)
        for f in dataclasses.fields(ModelConfig):
            assert getattr(port, f.name) == ref_d[f.name], (arch, f.name)
        assert (port.hd, port.pattern, port.n_super) == \
            (ref.hd, ref.pattern, ref.n_super)


@pytest.mark.parametrize("arch,backend,n_super", [
    (a, b, 1) for a in FAMILY for b in ("v2", "v3")] + [
    ("gemma3-12b", "v3", 2)])
def test_logits_and_greedy_tokens_match_reference(arch, backend, n_super):
    """Two superblocks of gemma check the layer order too: layer ``s * 6 +
    j`` is slot ``j`` of superblock ``s`` on both sides."""
    m = models(arch, n_super)
    ref = _reference_loop(m)
    papi, params = m["port_api"], m["port_packed"]
    logits, caches = papi.prefill(params, _tokens(), s_max=S_MAX, plen=PLEN,
                                  backend=backend)
    pos = np.array(PLEN)
    for step, r in enumerate(ref):
        _close(logits.numpy(), r)
        tok = logits.argmax(-1)
        assert np.array_equal(tok.numpy(), r.argmax(-1)), step
        if step < N_NEW:
            logits, caches = papi.decode_step(params, tok[:, None], caches,
                                              pos, backend=backend)
            pos = pos + 1


@pytest.mark.parametrize("arch", FAMILY)
def test_packed_operands_byte_identical(arch):
    """The port packs the reference's layout (``to_reference`` of its own
    per-layer params) byte for byte as the reference does: codes, signs,
    scales and every backend's operands, the untied ``lm_head``'s too."""
    m = models(arch)
    n_slots = len(m["cfg"].pattern)
    port = _convert(to_reference(from_reference(m["dense"], device="cpu"),
                                 n_slots), squeeze=1, backend="all")
    a = jax.tree_util.tree_leaves_with_path(port)
    b = jax.tree_util.tree_leaves_with_path(m["packed"])
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k
    if not m["cfg"].tie_embeddings:
        assert "sme_v3_planes" in port["lm_head"]["w"]


@pytest.mark.parametrize("arch,n_super", [(a, 1) for a in FAMILY]
                         + [("gemma3-12b", 2)])
def test_convert_round_trips_every_slot(arch, n_super):
    m = models(arch, n_super)
    n_slots = len(m["cfg"].pattern)
    for tree in (m["dense"], m["packed"]):
        port = from_reference(tree, device="cpu")
        assert len(port["blocks"]) == m["cfg"].n_layers
        # layer s * n_slots + j is slot j of superblock s
        for i, layer in enumerate(port["blocks"]):
            ref = tree["blocks"][f"slot{i % n_slots}"]["mix"]["q"]["w"]
            got = layer["mix"]["q"]["w"]
            if isinstance(got, dict):
                ref, got = ref["sme_codes"], got["sme_codes"]
            assert np.array_equal(got.numpy(), ref[i // n_slots]), i
        back = to_reference(port, n_slots)
        a = jax.tree_util.tree_leaves_with_path(back)
        b = jax.tree_util.tree_leaves_with_path(tree)
        assert [k for k, _ in a] == [k for k, _ in b]
        for (_, x), (_, y) in zip(a, b):
            assert x.dtype == np.asarray(y).dtype and np.array_equal(x, y)
    with pytest.raises(ValueError, match="superblocks"):
        to_reference(from_reference(m["dense"], device="cpu"), 5)


@pytest.mark.parametrize("backend", ["auto", "v3"])
def test_gemma_plan_json_byte_equal_to_reference(backend):
    m = models("gemma3-12b")
    ref = RPL.plan_model(m["dense"], error_budget=0.06, backend=backend)
    port = PPL.plan_model(to_reference(from_reference(m["dense"],
                                                      device="cpu"), 6),
                          error_budget=0.06, backend=backend)
    assert port.to_json() == ref.to_json()
    assert "lm_head/w" in port.layers
    assert {k.split("/")[1] for k in port.layers if k.startswith("blocks")} \
        == {f"slot{j}" for j in range(6)}


def test_packed_head_dispatch_matches_reference_kernel():
    """The untied head's ``sme_apply(..., out_dtype=float32)``: the port's
    v2 kernel (plain version) against the reference's v2 Pallas kernel in
    interpret mode (the one interpret-mode run of this file), on the same
    packed head."""
    m = models("gemma3-12b")
    head = m["packed"]["lm_head"]["w"]
    x = np.random.default_rng(4).standard_normal((2, 128)).astype(np.float32)
    ref = ref_sme_apply(jnp.asarray(x), jax.tree.map(jnp.asarray, head), "v2",
                        out_dtype=jnp.float32)
    got = sme_apply(torch.as_tensor(x), m["port_packed"]["lm_head"]["w"],
                    "v2", out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (2, 256)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("arch,change,missing", [
    ("qwen2-0.5b", dict(act="relu"), "MLP activations"),
    ("gemma3-12b", dict(family="cnn"), "family 'cnn'")])
def test_model_api_names_what_is_not_ported(arch, change, missing):
    with pytest.raises(NotImplementedError, match=missing):
        build_model(dataclasses.replace(ref_scale_down(REF_ARCHS[arch]),
                                        **change), device="cpu")
