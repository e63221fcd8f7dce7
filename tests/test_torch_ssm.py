"""The port's recurrent blocks (``models/ssm.py``) against the reference's
``repro.models.ssm``: Mamba (jamba-v0.1-52b's slot 0), mLSTM and sLSTM
(xlstm-1.3b's slots 0 and 7) at ``scale_down(d_model=128, ...,
dtype="float32")``, on the same numpy inputs and params: each ``*_apply``
without and with a ragged ``plen`` (one row at ``plen`` 1), each
``*_decode`` with an ``active`` mask, dense and packed under v1, v2 and v3
(the kernels' plain versions; the reference on its ``xla`` backend);
``_tail_window``; mLSTM over several chunks with a padded tail chunk.

Tolerance: outputs and states within 1e-5 of the reference's max |value|
(f32 on both sides; sums in different orders, and ``torch.logaddexp`` for
``jax.nn.softplus``, which is the same formula).  Inactive decode rows keep
their state bit for bit, and v1, v2 and v3 agree bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backend import use_backend
from repro.models import ssm as ref_ssm
from repro_torch.models import ssm

from _torch_small import RECURRENT, family_models, ref_state

TOL = 1e-5
#: kind -> (arch, superblock slot)
SLOTS = {"mamba": ("jamba-v0.1-52b", 0), "mlstm": ("xlstm-1.3b", 0),
         "slstm": ("xlstm-1.3b", 7)}
BACKENDS = ("dense", "v1", "v2", "v3")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(kind, backend):
    """(reference numpy mix params, port mix params, model bundle)."""
    arch, slot = SLOTS[kind]
    m = family_models(arch, **RECURRENT[arch])
    packed = backend != "dense"
    ref = jax.tree.map(lambda a: a[0], (m.packed if packed else m.dense)
                       ["blocks"][f"slot{slot}"]["mix"])
    port = (m.port_packed if packed else m.port_dense)["blocks"][slot]["mix"]
    return ref, port, m


def _x(shape, seed=5):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(port, ref, tol=TOL):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    assert not np.isnan(port).any()
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, err


def _ref_call(fn, *args, **kw):
    with use_backend("xla"):
        return fn(*args, **kw)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", list(SLOTS))
def test_apply_matches_reference(kind, backend, ragged):
    """Full-sequence apply of 2 rows x 37 steps (mLSTM in chunks of 16, so
    the tail chunk is padded): outputs at every valid step and the final
    states; a ragged batch ends row 1 after its first step."""
    ref_p, p, m = _setup(kind, backend)
    x = _x((2, 37, 128))
    plen = np.array([37, 1]) if ragged else None
    kw = {"chunk": 16} if kind == "mlstm" else {}
    ry, rs = _ref_call(getattr(ref_ssm, f"{kind}_apply"), _j(ref_p),
                       jnp.asarray(x), m.cfg, want_state=True,
                       plen=None if plen is None else jnp.asarray(
                           plen, jnp.int32), **kw)
    y, state = getattr(ssm, f"{kind}_apply")(
        p, torch.as_tensor(x), m.port_api.cfg,
        plen=None if plen is None else torch.as_tensor(plen),
        backend=None if backend == "dense" else backend, **kw)
    ry = np.asarray(ry)
    for i, n in enumerate(plen if ragged else (37, 37)):
        _close(y[i, :n].numpy(), ry[i, :n])
    rs = ref_state(kind, rs)
    assert set(state) == set(rs)
    for k in rs:
        _close(state[k].numpy(), rs[k])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", list(SLOTS))
def test_decode_matches_reference_and_freezes_inactive_rows(kind, backend):
    """Two decode steps from a prefilled state with rows 1 and 2 inactive
    in the first: outputs and states match the reference's, and the
    inactive rows' states are bitwise what they were."""
    ref_p, p, m = _setup(kind, backend)
    cfg, be = m.port_api.cfg, None if backend == "dense" else backend
    x = _x((3, 5, 128), 6)
    _, rs = _ref_call(getattr(ref_ssm, f"{kind}_apply"), _j(ref_p),
                      jnp.asarray(x), m.cfg, want_state=True)
    _, state = getattr(ssm, f"{kind}_apply")(p, torch.as_tensor(x), cfg,
                                             backend=be)
    dec, ref_dec = getattr(ssm, f"{kind}_decode"), \
        getattr(ref_ssm, f"{kind}_decode")
    for step, active in enumerate(([True, False, False], None)):
        x1 = _x((3, 1, 128), 7 + step)
        ry, rs = _ref_call(ref_dec, _j(ref_p), jnp.asarray(x1), rs, m.cfg,
                           active=None if active is None
                           else jnp.asarray(active))
        before = {k: t.clone() for k, t in state.items()}
        y, state = dec(p, torch.as_tensor(x1), state, cfg,
                       active=None if active is None
                       else torch.as_tensor(active), backend=be)
        _close(y[0].numpy() if active else y.numpy(),
               np.asarray(ry)[0] if active else np.asarray(ry))
        for k, v in ref_state(kind, rs).items():
            _close(state[k].numpy(), v)
        if active is not None:
            for k, t in state.items():
                assert torch.equal(t[1:], before[k][1:]), k
                assert not torch.equal(t[:1], before[k][:1]), k


@pytest.mark.parametrize("kind", list(SLOTS))
def test_packed_backends_bitwise_equal(kind):
    """v1, v2 and v3 give the same bits on a prefill and a decode step."""
    _, p, m = _setup(kind, "v1")
    cfg = m.port_api.cfg
    x = torch.as_tensor(_x((2, 20, 128), 8))
    outs = [getattr(ssm, f"{kind}_apply")(p, x, cfg, backend=b)
            for b in ("v1", "v2", "v3")]
    steps = [getattr(ssm, f"{kind}_decode")(p, x[:, :1], o[1], cfg,
                                           backend=b)
             for o, b in zip(outs, ("v1", "v2", "v3"))]
    for (y, s), (y2, s2) in ((outs[0], o) for o in outs[1:]):
        assert torch.equal(y, y2)
        assert all(torch.equal(s[k], s2[k]) for k in s)
    assert all(torch.equal(steps[0][0], s[0]) for s in steps[1:])


def test_tail_window_matches_reference():
    """Per-row conv windows of a ragged batch, rows shorter than the
    window included (zeros where the row has no input)."""
    xr = _x((4, 9, 16), 9)
    plen = np.array([9, 4, 2, 1])
    ref = ref_ssm._tail_window(jnp.asarray(xr), jnp.asarray(plen, jnp.int32),
                               4)
    got = ssm._tail_window(torch.as_tensor(xr), torch.as_tensor(plen), 4)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert not got[3, :2].any() and torch.equal(got[0], torch.as_tensor(
        xr[0, 6:]))


def test_mlstm_chunk_forms_agree():
    """mLSTM's chunkwise prefill at chunk 8, 16 and 1024 over 37 steps and
    its recurrent decode step by step compute the same function (to the
    stated tolerance, not bitwise: different rounding), also for a row
    that is padded past its ``plen``."""
    _, p, m = _setup("mlstm", "dense")
    cfg = m.port_api.cfg
    x = torch.as_tensor(_x((2, 37, 128), 10))
    plen = torch.tensor([37, 21])
    ys = [ssm.mlstm_apply(p, x, cfg, plen=plen, chunk=c) for c in
          (8, 16, 1024)]
    state = ssm.mlstm_state_init(cfg, 2, None, "cpu")
    steps = []
    for t in range(37):
        y, state = ssm.mlstm_decode(p, x[:, t:t + 1], state, cfg,
                                    active=t < plen)
        steps.append(y)
    rec = torch.cat(steps, dim=1)
    for y, s in ys:
        _close(y[0].numpy(), ys[-1][0][0].numpy())
        _close(y[1, :21].numpy(), rec[1, :21].numpy())
        for k in s:
            _close(s[k].numpy(), state[k].numpy())
