"""The paper's CNNs in the port (``repro_torch.models.cnn``) against the
reference's ``repro.models.cnn``, at ``widths=(8, 16, 32, 32)`` on 8x8
images: logits on the reference's init carried across (within 1e-5 of the
largest magnitude), the conv matrices (names, order, bitwise), their SME
operands (byte-identical) and crossbar counts (equal), ``cnn_loss`` (1e-5)
and its gradient (1e-4 of ``jax.grad``), and one AdamW step on both nets
(1e-5)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mapping as ref_mapping
from repro.core.integrate import pack_sme_param as ref_pack
from repro.core.quant import quantize as ref_quantize
from repro.core.squeeze import squeeze_out as ref_squeeze_out
from repro.data import image_task
from repro.models import cnn as R
from repro.optim import adamw as ref_adamw, cosine_schedule as ref_cos
from repro_torch.convert import cnn_from_reference, cnn_to_reference
from repro_torch.core import mapping
from repro_torch.core.integrate import pack_sme_param
from repro_torch.core.quant import quantize
from repro_torch.core.squeeze import squeeze_out
from repro_torch.models import cnn as P
from repro_torch.optim import adamw, cosine_schedule

WIDTHS = (8, 16, 32, 32)
IMG = 8
NETS = {"resnet": (R.resnet_init, R.resnet_apply, P.resnet_init,
                   P.resnet_apply),
        "mobilenet": (R.mobilenet_init, R.mobilenet_apply, P.mobilenet_init,
                      P.mobilenet_apply)}


@functools.lru_cache(maxsize=None)
def _net(name, widths=WIDTHS):
    r_init, r_apply, _, p_apply = NETS[name]
    params = jax.tree.map(np.asarray, r_init(jax.random.key(0),
                                             widths=widths))
    return (params, functools.partial(r_apply, widths=widths),
            functools.partial(p_apply, widths=widths))


def _task(n=16, seed=0):
    return image_task(n, size=IMG, seed=seed)


@functools.lru_cache(maxsize=None)
def _ref(name):
    """The reference's logits, loss and gradient on the task (jitted)."""
    params, r_apply, _ = _net(name)
    x, y = (jnp.asarray(a) for a in _task())
    rp = jax.tree.map(jnp.asarray, params)
    logits = jax.jit(r_apply)(rp, x)
    loss, grad = jax.jit(jax.value_and_grad(
        lambda p: R.cnn_loss(r_apply, p, x, y)))(rp)
    return logits, loss, grad


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", list(NETS))
def test_logits_match_reference(name):
    params, r_apply, p_apply = _net(name)
    x, _ = _task()
    want = _ref(name)[0]
    got = p_apply(cnn_from_reference(params, "cpu"), torch.as_tensor(x))
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("name", list(NETS))
def test_init_layout_and_round_trip(name):
    params, _, _ = _net(name)
    port = NETS[name][2](np.random.default_rng(0), widths=WIDTHS)
    assert jax.tree.structure(port) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(port), jax.tree.leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype
    back = cnn_to_reference(cnn_from_reference(params, "cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", list(NETS))
def test_conv_weight_matrices_and_operands(name):
    params, _, _ = _net(name)
    got = P.conv_weight_matrices(cnn_from_reference(params, "cpu"))
    want = R.conv_weight_matrices(params)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for key, w in want[:3] + want[-2:]:
        mine, ref = pack_sme_param(w, backend="all"), ref_pack(w,
                                                               backend="all")
        assert sorted(mine) == sorted(ref), key
        for k in ref:
            a, b = np.asarray(mine[k]), np.asarray(ref[k])
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (key, k)


@pytest.mark.parametrize("name", list(NETS))
def test_crossbar_counts_equal(name):
    """Conventional, SME and squeezed (1) crossbars of every conv matrix,
    counted as the paper tables count them, at the task's widths."""
    widths = (32, 64, 128, 128) if name == "resnet" else (32, 64, 96, 128)
    params, _, _ = _net(name, widths)
    mats = R.conv_weight_matrices(params)
    totals = []
    for mod, quant, sq_out in ((mapping, quantize, squeeze_out),
                               (ref_mapping, ref_quantize, ref_squeeze_out)):
        conv = sme = squeezed = 0
        for _, w in mats:
            q = quant(w, "sme", 8, 3)
            conv += mod.conventional_crossbar_total(w.shape, 8)
            sme += mod.sme_crossbar_count(q.codes, 8)
            squeezed += mod.squeezed_crossbar_count(sq_out(q.codes, 8, 1))
        totals.append((conv, sme, squeezed))
    assert totals[0] == totals[1]
    assert min(totals[0]) > 0


@pytest.mark.parametrize("name", list(NETS))
def test_loss_and_gradient_match_reference(name):
    params, r_apply, p_apply = _net(name)
    x, y = _task()
    _, r_loss, r_grad = _ref(name)
    tp = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True), params)
    loss = P.cnn_loss(p_apply, tp, torch.as_tensor(x), torch.as_tensor(y))
    loss.backward()
    assert abs(float(loss.detach()) - float(r_loss)) \
        <= 1e-5 * abs(float(r_loss))
    for g, rg in zip(jax.tree.leaves(jax.tree.map(lambda t: t.grad.numpy(),
                                                  tp)),
                     jax.tree.leaves(r_grad)):
        assert _rel(g, rg) <= 1e-4


@pytest.mark.parametrize("name", list(NETS))
def test_adamw_step_matches_reference(name):
    """One step of the reference CNN task's optimizer on both nets."""
    params, r_apply, p_apply = _net(name)
    x, y = _task()
    r_opt, opt = ref_adamw(ref_cos(5e-3, 10, 60)), adamw(
        cosine_schedule(5e-3, 10, 60))
    rp = jax.tree.map(jnp.asarray, params)
    g = _ref(name)[2]
    r_new, _ = r_opt.update(g, r_opt.init(rp), rp, jnp.int32(3))
    tp = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True), params)
    P.cnn_loss(p_apply, tp, torch.as_tensor(x), torch.as_tensor(y)).backward()
    grads = jax.tree.map(lambda t: t.grad, tp)
    new, _ = opt.update(grads, opt.init(tp), jax.tree.map(
        lambda t: t.detach(), tp), 3)
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), new)),
                    jax.tree.leaves(r_new)):
        assert _rel(a, b) <= 1e-5
