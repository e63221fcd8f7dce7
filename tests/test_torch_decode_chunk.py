"""``ModelAPI.decode_chunk`` of the port (``make_decode_chunk``) against the
reference's ``make_decode_chunk(api.decode_step)`` on the reference model
API without a mesh, against the port's own sequential decode steps, and
independent of the padded scan length K (DESIGN.md §6, §12).

Against the reference (dense f32 weights): ``live`` exact, live-step
logits within 1e-5 of the logits' max (the two sides sum in different
orders, as in ``test_torch_model.py``).  Inside the port: bitwise."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_small import small_models

S_MAX = 32
PLEN = np.array([9, 5, 12])
TOL = 1e-5


@pytest.fixture(scope="module")
def m():
    return small_models(backend="v3")


def _port_prefill(m, params, backend=None):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (3, 16))
    logits, caches = m.port_api.prefill(params, toks, s_max=S_MAX, plen=PLEN,
                                        backend=backend)
    return toks, logits, caches


def _greedy(m, params, caches, first, n, backend=None):
    """The next ``n`` greedy tokens of every row after ``first`` (on a copy
    of the caches)."""
    caches = copy.deepcopy(caches)
    tok, pos, out = first.reshape(-1, 1), PLEN.copy(), []
    for _ in range(n):
        lg, caches = m.port_api.decode_step(params, tok, caches, pos,
                                            backend=backend)
        tok = lg.argmax(-1).reshape(-1, 1)
        out.append(tok[:, 0].numpy())
        pos = pos + 1
    return np.stack(out, 1)


def _chunk_inputs(m, params, caches, first, backend=None):
    """Row 0 gated: its greedy continuation with a wrong 4th token, so it
    accepts 2 draft tokens and stops; row 1 plain, 2 valid; row 2 plain,
    4 valid, starting from random tokens."""
    g = _greedy(m, params, caches, first, 4, backend)
    toks = np.zeros((3, 4), np.int64)
    toks[:, 0] = first
    toks[0, 1:3] = g[0, :2]
    toks[0, 3] = (g[0, 2] + 1) % 256
    toks[1:, 1:] = np.random.default_rng(1).integers(0, 256, (2, 3))
    return toks, np.array([4, 2, 4]), np.array([True, False, False])


def test_decode_chunk_matches_reference_make_decode_chunk(m):
    toks16, logits, caches = _port_prefill(m, m.port_dense)
    first = logits.argmax(-1).numpy()
    toks, nvalid, gated = _chunk_inputs(m, m.port_dense, caches, first)
    # jnp params: the reference's scan traces its embedding gather
    dense = jax.tree.map(jnp.asarray, m.dense)
    rl, rc = m.api.prefill(dense, {"tokens": jnp.asarray(toks16)},
                           s_max=S_MAX, plen=jnp.asarray(PLEN))
    assert (np.asarray(rl).argmax(-1) == first).all()
    rlog, rlive, _ = m.api.decode_chunk(
        dense, jnp.asarray(toks, jnp.int32), rc, jnp.asarray(PLEN),
        jnp.asarray(nvalid), jnp.ones(3, bool), jnp.asarray(gated))
    plog, plive, _ = m.port_api.decode_chunk(
        m.port_dense, toks, copy.deepcopy(caches), PLEN, nvalid,
        np.ones(3, bool), gated)
    rlive = np.asarray(rlive)
    np.testing.assert_array_equal(plive.numpy(), rlive)
    # the gated row accepted its two greedy draft tokens, then stopped
    assert rlive[:, 0].tolist() == [True, True, True, False]
    rlog = np.asarray(rlog, np.float64)
    diff = np.abs(plog.numpy().astype(np.float64) - rlog)[rlive]
    assert diff.max() <= TOL * np.abs(rlog[rlive]).max()


@pytest.mark.parametrize("backend", [None, "v3"], ids=["dense", "v3"])
def test_decode_chunk_equals_sequential_steps_bitwise(m, backend):
    params = m.port_dense if backend is None else m.port_packed
    _, logits, caches = _port_prefill(m, params, backend)
    first = logits.argmax(-1).numpy()
    toks, nvalid, gated = _chunk_inputs(m, params, caches, first, backend)
    clog, clive, cc = m.port_api.decode_chunk(
        params, toks, copy.deepcopy(caches), PLEN, nvalid, None, gated,
        backend=backend)
    sc = copy.deepcopy(caches)
    live, pos = nvalid > 0, PLEN.copy()
    for s in range(toks.shape[1]):
        lg, sc = m.port_api.decode_step(params, toks[:, s:s + 1], sc,
                                        np.where(live, pos, 0), live,
                                        backend=backend)
        assert clive[s].tolist() == live.tolist()
        assert torch.equal(clog[s][torch.as_tensor(live)],
                           lg[torch.as_tensor(live)])
        greedy = lg.argmax(-1).numpy()
        pos = np.where(live, pos + 1, pos)
        live = live & (s + 1 < nvalid) & (~gated | (greedy == toks[:, (s + 1)
                                                                   % 4]))
    for a, b in zip(cc, sc):
        for name in a:
            assert torch.equal(a[name], b[name])


def test_decode_chunk_does_not_depend_on_padded_k(m):
    params = m.port_packed
    _, logits, caches = _port_prefill(m, params, "v3")
    toks, nvalid, gated = _chunk_inputs(m, params, caches,
                                        logits.argmax(-1).numpy(), "v3")
    short = m.port_api.decode_chunk(params, toks, copy.deepcopy(caches),
                                    PLEN, nvalid, None, gated, backend="v3")
    padded = np.concatenate([toks, np.full((3, 4), 7)], axis=1)
    long = m.port_api.decode_chunk(params, padded, copy.deepcopy(caches),
                                   PLEN, nvalid, None, gated, backend="v3")
    assert not long[1][4:].any()
    assert torch.equal(long[1][:4], short[1])
    assert torch.equal(long[0][:4][short[1]], short[0][short[1]])
    for a, b in zip(long[2], short[2]):
        for name in a:
            assert torch.equal(a[name], b[name])
