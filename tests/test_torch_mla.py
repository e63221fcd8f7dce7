"""MLA attention and deepseek's leading dense layer in the port against the
reference: ``mla_prefill``/``mla_decode`` and the whole model (``first0``
then one MoE superblock) at ``scale_down(d_model=128, expert_dff=128,
dtype="float32")``, whose ``kv_lora`` of 32 stays dense as in the
reference's own tests; and at ``kv_lora`` 128, where ``kv_up`` is packed:
the reference cannot decode that tree (ROADMAP R4), so the port's decode
on it is held against the reference's on the same tree with ``kv_up``
replaced by its dequantized weight, which the port builds once per layer.

Tolerance: 1e-5 of the logits' max |value| and 5e-5 of a layer output's
(f32 on both sides, summed in different orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backend import use_backend
from repro.models import attention as RA
from repro_torch.core.backend import cached_dequant
from repro_torch.models import attention as PA

from _torch_small import dequantized, family_models

ARCH = "deepseek-v2-lite-16b"
OVER = dict(d_model=128, expert_dff=128, dtype="float32")
S_MAX, PLEN, N_NEW = 32, (20, 13), 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(port, ref, tol):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    err = np.abs(port - ref).max() / np.abs(ref).max()
    assert err <= tol, err


def _tokens():
    toks = np.random.default_rng(13).integers(0, 256, (2, max(PLEN)))
    for i, n in enumerate(PLEN):
        toks[i, n:] = 0
    return toks


def test_mla_layer_prefill_and_decode_match_reference():
    """One MLA layer (``first0``'s): ragged prefill output and compressed
    cache, then two decode steps with one row inactive on the second."""
    m = family_models(ARCH, **OVER)
    ref_p = jax.tree.map(jnp.asarray, m.dense["first0"]["mix"])
    p = m.port_dense["first0"]["mix"]
    cfg, pcfg = m.cfg, m.port_api.cfg
    x = np.random.default_rng(14).standard_normal((2, 20, 128)).astype(
        np.float32)
    plen = np.array(PLEN)
    ry, rc = RA.mla_prefill(ref_p, jnp.asarray(x), cfg, cache_len=S_MAX,
                            plen=jnp.asarray(plen))
    y, c = PA.mla_prefill(p, torch.as_tensor(x), pcfg, cache_len=S_MAX,
                          plen=torch.as_tensor(plen))
    _close(y.numpy(), ry, 5e-5)
    assert set(c) == {"c", "k_pe"} and c["c"].shape == (2, S_MAX, 32) \
        and c["k_pe"].shape == (2, S_MAX, 8)
    for k in c:
        _close(c[k].numpy(), rc[k], 5e-5)
        assert not c[k][1, PLEN[1]:].any()
    pos = plen.copy()
    for active in (None, np.array([True, False])):
        xt = np.random.default_rng(int(pos[0])).standard_normal(
            (2, 1, 128)).astype(np.float32)
        ry, rc = RA.mla_decode(ref_p, jnp.asarray(xt), rc, jnp.asarray(pos),
                               cfg, active=None if active is None
                               else jnp.asarray(active))
        y, c = PA.mla_decode(p, torch.as_tensor(xt), c, torch.as_tensor(pos),
                             pcfg, active=None if active is None
                             else torch.as_tensor(active))
        _close(y.numpy(), ry, 5e-5)
        for k in c:
            _close(c[k].numpy(), rc[k], 5e-5)
        pos = pos + 1


def _reference_loop(m, params):
    api = m.api
    prefill = jax.jit(lambda p, t, n: api.prefill(p, {"tokens": t},
                                                  s_max=S_MAX, plen=n))
    step = jax.jit(api.decode_step)
    params = jax.tree.map(jnp.asarray, params)
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


def _port_loop(m, params, backend, ref):
    api = m.port_api
    logits, caches = api.prefill(params, _tokens(), s_max=S_MAX, plen=PLEN,
                                 backend=backend)
    assert len(caches) == 2 and set(caches[0]) == {"c", "k_pe"}
    pos = np.array(PLEN)
    for step, r in enumerate(ref):
        _close(logits.numpy(), r, 1e-5)
        tok = logits.argmax(-1)
        assert np.array_equal(tok.numpy(), r.argmax(-1)), step
        if step < N_NEW:
            logits, caches = api.decode_step(params, tok[:, None], caches,
                                             pos, backend=backend)
            pos = pos + 1


@pytest.mark.parametrize("backend", ["dense", "v2", "v3"])
def test_first0_and_moe_model_match_reference(backend):
    """The whole model (``first0`` dense, then an MLA + MoE superblock):
    ragged prefill and greedy decode, dense and packed (the first layer's
    MLP and the experts packed; ``kv_lora`` 32 keeps ``kv_up`` dense)."""
    m = family_models(ARCH, **OVER)
    assert isinstance(m.packed["first0"]["mlp"]["wi"]["w"], dict)
    assert not isinstance(m.packed["first0"]["mix"]["kv_up"]["w"], dict)
    ref = _reference_loop(m, m.dense if backend == "dense" else m.packed)
    _port_loop(m, m.port_dense if backend == "dense" else m.port_packed,
               None if backend == "dense" else backend, ref)


@pytest.mark.parametrize("backend", ["v2", "v3"])
def test_packed_kv_up_decodes(backend):
    """R4: at ``kv_lora`` 128 ``kv_up`` [128, 128] is packed in both
    layers.  The reference's decode raises on that tree; the port's
    equals the reference's on the tree with each ``kv_up`` dequantized,
    and builds each layer's matrix once over the prefill and every
    decode step."""
    m = family_models(ARCH, **OVER, kv_lora=128)
    kv_up = m.packed["blocks"]["slot0"]["mix"]["kv_up"]["w"]
    assert isinstance(kv_up, dict) and "sme_codes" in kv_up
    params = jax.tree.map(jnp.asarray, m.packed)
    with use_backend("xla"), pytest.raises(AttributeError):
        _, caches = m.api.prefill(params, {"tokens": jnp.asarray(
            _tokens(), jnp.int32)}, s_max=S_MAX)
        m.api.decode_step(params, jnp.zeros((2, 1), jnp.int32), caches,
                          jnp.asarray(PLEN, jnp.int32))
    tree = dequantized(dequantized(m.packed, "first0", "mix", "kv_up", "w"),
                       "blocks", "slot0", "mix", "kv_up", "w")
    ref = _reference_loop(m, tree)
    before = cached_dequant.builds
    _port_loop(m, m.port_packed, backend, ref)
    # one matrix per layer, cached across the decode steps (a second
    # backend's run reuses them: the cache is keyed on the weight)
    assert cached_dequant.builds - before in (0, 2)
    assert torch.equal(
        cached_dequant(m.port_packed["first0"]["mix"]["kv_up"]["w"]),
        torch.tensor(np.array(tree["first0"]["mix"]["kv_up"]["w"])))
