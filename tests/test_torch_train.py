"""Training in the port against the reference: ``ModelAPI.train_loss``
(within 1e-5) and its autograd gradient (each leaf within 1e-4 of its
largest magnitude, compared with ``jax.grad`` of the reference's loss
through ``convert.to_reference``) for every family, at 128 wide, f32 (two
layers, or one superblock); ``make_train_step`` at 1 and 2 microbatches
against the reference's over 2 steps; a packed tree refused; and
``launch/train.py`` in-process on the CPU with ``--resume``.  The
reference runs jitted on its ``xla`` backend; batches come from
``repro_torch.data.lm_batches`` (bitwise the reference's)."""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS, scale_down as ref_scale_down
from repro.models import build_model as ref_build_model
from repro.optim import adamw as ref_adamw, cosine_schedule as ref_cos
from repro.train import make_train_step as ref_make_train_step
from repro_torch.configs import ARCHS, SMOKE_SHAPE, get_smoke, scale_down
from repro_torch.convert import from_reference, to_reference
from repro_torch.data import lm_batches
from repro_torch.models.model import build_model
from repro_torch.models.moe import moe_drops
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.train import make_train_step, pick_microbatches, train_loop

from _torch_small import RECURRENT, SMALL

W128 = dict(d_model=128, d_ff=256, head_dim=32, n_heads=4, vocab=256,
            dtype="float32")
SIZES = {
    "qwen1.5-0.5b": SMALL,
    "gemma3-12b": dict(W128, n_kv_heads=2),
    "mixtral-8x7b": dict(d_model=128, expert_dff=128, dtype="float32"),
    "deepseek-v2-lite-16b": dict(d_model=128, expert_dff=128,
                                 dtype="float32"),
    "llava-next-34b": W128,
    "xlstm-1.3b": RECURRENT["xlstm-1.3b"],
    "jamba-v0.1-52b": RECURRENT["jamba-v0.1-52b"],
    "whisper-medium": dict(W128, n_kv_heads=4, n_layers=2),
}
BATCH, SEQ = 2, 16


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _models(arch):
    over = SIZES[arch]
    cfg = ref_scale_down(REF_ARCHS[arch], **over)
    api = ref_build_model(cfg)
    dense = jax.tree.map(np.asarray, api.init_params(jax.random.key(3)))
    fe = None
    if cfg.frontend == "vision_stub":
        fe = {"kind": "vision_stub", "n": cfg.n_frontend_tokens,
              "d": cfg.d_model}
    elif cfg.n_enc_layers:
        fe = {"kind": "audio_stub", "src": SEQ, "d": cfg.d_model}
    batches = lm_batches(cfg.vocab, BATCH, SEQ, seed=4, frontend=fe)
    return types.SimpleNamespace(
        cfg=cfg, api=api, dense=dense, batches=[next(batches)
                                                for _ in range(2)],
        port_api=build_model(scale_down(ARCHS[arch], **over), device="cpu"),
        n_slots=len(cfg.pattern))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _port_params(m, grad=False):
    p = from_reference(m.dense, device="cpu")
    return jax.tree.map(lambda t: t.requires_grad_(grad), p)


@pytest.mark.parametrize("arch", list(SIZES))
def test_train_loss_and_gradient_match_reference(arch):
    m = _models(arch)
    batch = m.batches[0]
    r_loss, r_grad = jax.jit(jax.value_and_grad(m.api.train_loss))(
        jax.tree.map(jnp.asarray, m.dense), jax.tree.map(jnp.asarray, batch))
    params = _port_params(m, grad=True)
    moe_drops.update(dropped=0, routed=0)
    loss = m.port_api.train_loss(params, batch)
    loss.backward()
    # the MoE routing counters are integer counts: they keep no graph
    assert not any(getattr(v, "requires_grad", False)
                   for v in moe_drops.values())
    assert _rel(loss.detach(), r_loss) <= 1e-5, (float(loss), float(r_loss))
    grads = to_reference(jax.tree.map(lambda t: t.grad, params), m.n_slots)
    flat = jax.tree_util.tree_leaves_with_path(grads)
    want = jax.tree_util.tree_leaves_with_path(r_grad)
    assert [k for k, _ in flat] == [k for k, _ in want]
    for (k, g), (_, rg) in zip(flat, want):
        assert g.shape == rg.shape, k
        assert _rel(g, rg) <= 1e-4, (jax.tree_util.keystr(k), _rel(g, rg))


@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_reference(micro):
    """Two AdamW steps (weight decay, clip, cosine schedule) of the
    reference's ``make_train_step`` and the port's, on the same params and
    batches: the losses, and the params and each optimizer-state tree
    within 1e-5 of the tree's largest magnitude.  (Not each leaf's: the
    key bias's gradient is rounding noise, since a uniform shift of every
    key leaves the softmax unchanged, and Adam's normalization turns that
    noise into steps of order lr.)"""
    m = _models("qwen1.5-0.5b")
    r_opt = ref_adamw(ref_cos(3e-3, 1, 4), weight_decay=0.01)
    opt = adamw(cosine_schedule(3e-3, 1, 4), weight_decay=0.01)
    r_step = jax.jit(ref_make_train_step(m.api.train_loss, r_opt, micro))
    step = make_train_step(m.port_api.train_loss, opt, micro)
    rp = jax.tree.map(jnp.asarray, m.dense)
    r_state = r_opt.init(rp)
    params = _port_params(m)
    state = opt.init(params)
    for i, batch in enumerate(m.batches):
        rp, r_state, r_loss = r_step(rp, r_state, jnp.int32(i),
                                     jax.tree.map(jnp.asarray, batch))
        params, state, loss = step(params, state, i, batch)
        assert _rel(loss, r_loss) <= 1e-5
    pairs = [(to_reference(params), rp)] + [
        (to_reference(state[k]), r_state[k]) for k in ("m", "v")]
    for got, want in pairs:
        flat = jax.tree_util.tree_leaves_with_path(got)
        ref = jax.tree_util.tree_leaves_with_path(want)
        assert [k for k, _ in flat] == [k for k, _ in ref]
        top = max(float(np.abs(np.asarray(b)).max()) for _, b in ref)
        for (k, a), (_, b) in zip(flat, ref):
            err = float(np.abs(a - np.asarray(b)).max())
            assert err <= 1e-5 * top, (jax.tree_util.keystr(k), err, top)


def test_train_loop_steps_and_logs(capsys):
    """``train_loop`` over the step of ``make_train_step``: its history
    holds the logged steps' losses, equal to the step's own."""
    m = _models("qwen1.5-0.5b")
    opt = adamw(3e-3)
    out = train_loop(m.port_api, _port_params(m), opt, iter(m.batches), 2,
                     log_every=1)
    assert [i for i, _ in out["history"]] == [0, 1]
    step = make_train_step(m.port_api.train_loss, opt)
    params, state = _port_params(m), opt.init(_port_params(m))
    for i, b in enumerate(m.batches):
        params, state, loss = step(params, state, i, b)
        assert out["history"][i][1] == float(loss)
    assert "step     1 loss" in capsys.readouterr().out


def test_packed_tree_refused():
    from repro_torch.core.integrate import convert_params_to_sme
    m = _models("qwen1.5-0.5b")
    packed = convert_params_to_sme(_port_params(m), device="cpu")
    with pytest.raises(ValueError, match="dense weights.*blocks/0/mix/"):
        m.port_api.train_loss(packed, m.batches[0])


def test_pick_microbatches_matches_reference():
    from repro.configs import (SHAPES as REF_SHAPES, SMOKE_SHAPE as
                               REF_SMOKE, get_smoke as ref_smoke)
    from repro.train import pick_microbatches as ref_pick
    from repro_torch.configs import SHAPES
    for arch in ("qwen1.5-0.5b", "mixtral-8x7b", "xlstm-1.3b"):
        for name, sh in SHAPES.items():
            for dp in (1, 8):
                assert pick_microbatches(ARCHS[arch], sh, dp) == ref_pick(
                    REF_ARCHS[arch], REF_SHAPES[name], dp)
        assert pick_microbatches(get_smoke(arch), SMOKE_SHAPE, 1) == \
            ref_pick(ref_smoke(arch), REF_SMOKE, 1)


def test_train_launcher_resumes_in_process(tmp_path, capsys):
    """``launch/train.py --small --device cpu`` for 3 steps with
    checkpoints, then resumed from its own latest for 2 more at 2
    microbatches: the resumed run starts from the saved state bitwise."""
    from repro_torch.launch import train
    from repro_torch.train.checkpoint import latest_step, restore
    argv = ["--arch", "qwen1.5-0.5b", "--small", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    first = train.main(argv + ["--steps", "3"])
    assert sorted(first["losses"]) == [0, 1, 2]
    assert all(np.isfinite(v) for v in first["losses"].values())
    assert latest_step(tmp_path) == 2
    saved = restore(tmp_path, None, first["state_tree"](
        first["params"], first["opt_state"]))
    live = first["state_tree"](first["params"], first["opt_state"])
    for a, b in zip(jax.tree.leaves(saved), jax.tree.leaves(live)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    second = train.main(argv + ["--steps", "5", "--micro", "2",
                                "--resume"])
    assert second["step0"] == 3 and sorted(second["losses"]) == [3, 4]
    assert "resumed from step 2" in capsys.readouterr().out
    assert (tmp_path / f"{first['cfg'].name}.heartbeat").exists()
