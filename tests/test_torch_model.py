"""Model parity of the port: a small qwen1.5-0.5b (2 layers, 128 wide, every
linear SME-packed to v3) carried from the reference with ``convert.py``
gives the reference model API's prefill logits (ragged ``plen``) and three
decode steps, and the same greedy tokens.

Both sides run in f32 (``dtype="float32"``: the reference computes in f32
with numpy params whatever the config says, ROADMAP R2).  Tolerance 1e-5
of the logits' max: the two sides sum in different orders (XLA vs torch
matmul, einsum, softmax, rope), each f32 op adding a few ulp."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS, scale_down as ref_scale_down
from repro.core.integrate import convert_params_to_sme as ref_convert
from repro.models import build_model as ref_build_model
from repro_torch.configs import ARCHS, ModelConfig, scale_down
from repro_torch.convert import from_reference
from repro_torch.models.model import build_model

SMALL = dict(d_model=128, d_ff=256, head_dim=32, n_heads=4, n_kv_heads=4,
             vocab=256, n_layers=2, dtype="float32")
TOL = 1e-5


def _reference_model():
    cfg = ref_scale_down(REF_ARCHS["qwen1.5-0.5b"], **SMALL)
    api = ref_build_model(cfg)
    params = jax.tree.map(np.asarray, api.init_params(jax.random.key(0)))
    rng = np.random.default_rng(0)
    # a small embedding lets the layers, not the tied head's echo of the
    # input token, pick the next token; random biases exercise the bias add
    params["embed"]["w"] = params["embed"]["w"] * np.float32(0.05)
    mix = params["blocks"]["slot0"]["mix"]
    for name in ("q", "k", "v"):
        mix[name]["b"] = rng.normal(0, 0.1, mix[name]["b"].shape
                                    ).astype(np.float32)
    return cfg, api, params


@pytest.fixture(scope="module")
def models():
    cfg, api, dense = _reference_model()
    packed = ref_convert(dense, squeeze=1, backend="v3")
    port_cfg = scale_down(ARCHS["qwen1.5-0.5b"], **SMALL)
    return dict(cfg=cfg, api=api, dense=dense, packed=packed,
                port_cfg=port_cfg,
                port_api=build_model(port_cfg, device="cpu"),
                port_packed=from_reference(jax.tree.map(np.asarray, packed),
                                           device="cpu"))


def _close(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert np.abs(port - ref).max() <= TOL * np.abs(ref).max(), \
        np.abs(port - ref).max() / np.abs(ref).max()


def test_config_matches_reference(models):
    ref = dataclasses.asdict(models["cfg"])
    port = dataclasses.asdict(models["port_cfg"])
    for f in dataclasses.fields(ModelConfig):
        assert port[f.name] == ref[f.name], f.name
    assert models["port_cfg"].hd == models["cfg"].hd


def test_prefill_and_decode_match_reference(models):
    """Prefill of 2 rows x 40 tokens (M = 80 > 64: the prefill kernel's
    path) with ragged plen, then 3 greedy decode steps (the decode
    kernel's path), against the reference model API with backend v3."""
    api, params = models["api"], models["packed"]
    papi, pparams = models["port_api"], models["port_packed"]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 256, (2, 40))
    plen = np.array([40, 27])
    from repro.core.backend import use_backend
    with use_backend("v3"):
        rl, rc = api.prefill(params, {"tokens": jnp.asarray(toks)},
                             s_max=64, plen=jnp.asarray(plen))
    pl, pc = papi.prefill(pparams, toks, s_max=64, plen=plen, backend="v3")
    _close(pl.numpy(), rl)
    tok, pos = np.asarray(rl).argmax(-1), plen.copy()
    assert (pl.numpy().argmax(-1) == tok).all()
    for _ in range(3):
        with use_backend("v3"):
            rl, rc = api.decode_step(params, jnp.asarray(tok[:, None]), rc,
                                     jnp.asarray(pos))
        pl, pc = papi.decode_step(pparams, tok[:, None], pc, pos,
                                  backend="v3")
        _close(pl.numpy(), rl)
        tok = np.asarray(rl).argmax(-1)
        assert (pl.numpy().argmax(-1) == tok).all()
        pos = pos + 1


def test_dense_and_torch_backend_match_reference(models):
    """The operand-free paths: dense params, and packed params served by
    the dequant (``torch``) backend, against the reference's xla path."""
    api, dense, packed = models["api"], models["dense"], models["packed"]
    papi = models["port_api"]
    toks = np.random.default_rng(2).integers(0, 256, (3, 16))
    rl, _ = api.prefill(dense, {"tokens": jnp.asarray(toks)}, s_max=32)
    pl, _ = papi.prefill(from_reference(dense, device="cpu"), toks, s_max=32)
    _close(pl.numpy(), rl)
    from repro.core.backend import use_backend
    with use_backend("xla"):
        rl, _ = api.prefill(packed, {"tokens": jnp.asarray(toks)}, s_max=32)
    pl, _ = papi.prefill(models["port_packed"], toks, s_max=32,
                         backend="torch")
    _close(pl.numpy(), rl)


def test_port_conversion_serves_the_same_function(models):
    """Dense reference weights packed by the port itself (per layer) give
    the logits of the reference-packed tree carried across."""
    papi = models["port_api"]
    from repro_torch.core.integrate import convert_params_to_sme
    own = convert_params_to_sme(from_reference(models["dense"], device="cpu"),
                                squeeze=1, backend="v3", device="cpu")
    toks = np.random.default_rng(3).integers(0, 256, (1, 24))
    a, _ = papi.prefill(own, toks, s_max=32, backend="v3")
    b, _ = papi.prefill(models["port_packed"], toks, s_max=32, backend="v3")
    assert torch.equal(a, b)


def test_cache_rows_stop_at_plen_and_inactive_rows_keep_cache(models):
    papi, pparams = models["port_api"], models["port_packed"]
    toks = np.random.default_rng(4).integers(0, 256, (2, 16))
    _, caches = papi.prefill(pparams, toks, s_max=32, plen=[16, 9])
    assert (caches[0]["k"][1, 9:] == 0).all()
    assert (caches[0]["k"][1, :9] != 0).any()
    before = [c["k"][1].clone() for c in caches]
    _, caches = papi.decode_step(pparams, np.array([[3], [4]]), caches,
                                 np.array([16, 9]), np.array([True, False]))
    for b, c in zip(before, caches):
        assert torch.equal(b, c["k"][1])
    assert (caches[0]["k"][0, 16] != 0).any()
