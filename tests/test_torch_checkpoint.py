"""Checkpoints and fault tolerance of the port (``repro_torch.train``)
against the reference's ``repro.train``: a reference-written checkpoint
(params and AdamW state) restores bitwise in the port and the reverse;
atomic saves; the manager's keep/collect and async saves; shape checks;
``retry_transient``, ``StragglerDetector`` and ``run_resumable`` as
``test_substrate.py`` holds the reference's; ``compile --ckpt`` of a
reference-written params checkpoint plans byte-equal to the reference's
compiler; and ROADMAP R9: a ``launch/train.py`` checkpoint is refused by
both compilers."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS, scale_down as ref_scale_down
from repro.models import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro.train import checkpoint as R
from repro_torch.convert import from_reference, to_reference
from repro_torch.launch.compile import SMALL
from repro_torch.train import checkpoint as P
from repro_torch.train.fault import (Heartbeat, StragglerDetector,
                                     TransientError, retry_transient,
                                     run_resumable)


def _ref_state():
    """A reference params tree (qwen at the compiler's ``--small``) and
    its AdamW state after one update, as numpy."""
    cfg = ref_scale_down(REF_ARCHS["qwen1.5-0.5b"], **SMALL)
    params = ref_build_model(cfg).init_params(jax.random.key(5))
    opt = ref_adamw(1e-3)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.01), params)
    params, state = opt.update(grads, opt.init(params), params, jnp.int32(0))
    return jax.tree.map(np.asarray, {"params": params, "opt": state})


def _equal(a, b):
    fa = jax.tree_util.tree_leaves_with_path(a)
    fb = jax.tree_util.tree_leaves_with_path(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y), k


def _port_like(tree):
    """The port's own state (per-layer tensors), in the checkpoint's
    reference layout."""
    port = {"params": from_reference(tree["params"], "cpu"),
            "opt": {k: from_reference(v, "cpu")
                    for k, v in tree["opt"].items()}}
    return {"params": to_reference(port["params"]),
            "opt": {k: to_reference(v) for k, v in port["opt"].items()}}


def test_reference_checkpoint_restores_bitwise_in_port(tmp_path):
    tree = _ref_state()
    R.save(tmp_path, 7, jax.tree.map(jnp.asarray, tree), extra={"a": 1})
    like = jax.tree.map(np.zeros_like, _port_like(tree))
    got = P.restore(tmp_path, None, like)
    _equal(got, tree)
    on_dev = P.restore(tmp_path, 7, like, device="cpu")
    assert torch.is_tensor(on_dev["params"]["embed"]["w"])
    params = from_reference(jax.tree.map(lambda t: t.numpy(),
                                         on_dev["params"]), "cpu")
    assert torch.equal(params["blocks"][1]["mix"]["q"]["w"], torch.tensor(
        tree["params"]["blocks"]["slot0"]["mix"]["q"]["w"][1]))


def test_port_checkpoint_restores_bitwise_in_reference(tmp_path):
    tree = _ref_state()
    P.save(tmp_path, 3, _port_like(tree))
    got = R.restore(tmp_path, None, jax.tree.map(jnp.asarray, tree))
    _equal(got, tree)
    P.save_async(tmp_path / "a", 4, _port_like(tree))
    P.wait_for_async()
    _equal(R.restore(tmp_path / "a", 4, tree), tree)
    # same files: the manifests agree key for key
    P.save(tmp_path / "p", 1, tree, extra={"x": 2})
    R.save(tmp_path / "r", 1, jax.tree.map(jnp.asarray, tree),
           extra={"x": 2})
    mp = (tmp_path / "p/step_00000001/manifest.json").read_text()
    mr = (tmp_path / "r/step_00000001/manifest.json").read_text()
    assert mp == mr


def test_checkpoint_atomic_no_partial(tmp_path, monkeypatch):
    tree = {"a": torch.zeros(10)}
    P.save(tmp_path, 1, tree)
    # a stale tmp dir must not break later saves and restores
    (tmp_path / "step_00000002.tmp").mkdir()
    P.save(tmp_path, 2, tree)
    assert P.latest_step(tmp_path) == 2
    # a crash inside the write leaves no step directory behind

    def boom(*a, **k):
        raise RuntimeError("disk gone")
    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(RuntimeError):
        P.save(tmp_path, 3, tree)
    assert P.latest_step(tmp_path) == 2
    assert not (tmp_path / "step_00000003").exists()


def test_checkpoint_manager_matches_reference(tmp_path):
    """Saves every 2 steps, keeps 2, asynchronously; the same steps
    survive as under the reference's manager."""
    kept = []
    for mod, sub, tree in ((P, "p", {"a": torch.arange(3.0)}),
                           (R, "r", {"a": jnp.arange(3.0)})):
        mgr = mod.CheckpointManager(tmp_path / sub, every=2, keep=2,
                                    async_save=True)
        saved = [s for s in range(7) if mgr.maybe_save(s, tree)]
        mod.wait_for_async()
        mgr._gc()
        kept.append((saved, sorted(p.name for p in
                                   (tmp_path / sub).glob("step_????????"))))
        got = mgr.restore_latest({"a": np.zeros(3, np.float32)})
        assert np.array_equal(np.asarray(got["a"]), np.arange(3.0))
    assert kept[0] == kept[1] == ([0, 2, 4, 6],
                                  ["step_00000004", "step_00000006"])


def test_checkpoint_shape_check(tmp_path):
    P.save(tmp_path, 0, {"a": torch.zeros((4, 4))})
    with pytest.raises(ValueError, match="shape"):
        P.restore(tmp_path, 0, {"a": torch.zeros((2, 2))})
    with pytest.raises(FileNotFoundError):
        P.restore(tmp_path / "none", None, {"a": torch.zeros(1)})


# ------------------------------------------------------------------ fault
def test_retry_transient_succeeds_after_failures():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise TransientError("boom")
        return 42

    assert retry_transient(flaky, attempts=4, backoff=0.01) == 42
    with pytest.raises(TransientError):
        retry_transient(lambda: (_ for _ in ()).throw(TransientError("x")),
                        attempts=2, backoff=0.0)


def test_straggler_detector_flags_slow_step():
    flagged = []
    det = StragglerDetector(threshold=2.0, warmup=1,
                            on_straggler=lambda s, dt, e: flagged.append(s))
    for s, dt in enumerate([1.0, 1.0, 1.0, 5.0, 1.0]):
        det.observe(s, dt)
    assert flagged == [3]
    assert det.ema < 2.0  # the outlier is not folded into the EMA


def test_run_resumable_with_injected_failures(tmp_path):
    hb = Heartbeat(tmp_path / "hb.json")
    fails = {3: 1}

    def injector(step):
        if fails.get(step, 0) > 0:
            fails[step] -= 1
            raise TransientError("injected")

    log = []
    mgr = P.CheckpointManager(tmp_path / "ck", every=2, keep=5,
                              async_save=False)
    state = run_resumable(lambda s, st: log.append(s) or st + 1, state=0,
                          start_step=0, n_steps=6, ckpt_manager=mgr,
                          heartbeat=hb, detector=StragglerDetector(),
                          fail_injector=injector)
    assert log == list(range(6)) and state == 6
    assert hb.age() is not None and hb.age() < 10
    assert P.latest_step(tmp_path / "ck") == 4


# ---------------------------------------------------------- compile --ckpt
def _ref_compile_plan(tree, out):
    """The reference compiler CLI's steps after its restore."""
    from repro.compiler import compile_model
    _, plan = compile_model(tree, out=str(out), error_budget=0.06,
                            backend="auto", reorder=True, measure="trial",
                            objective="bytes")
    return plan


def test_compile_ckpt_plans_as_reference(tmp_path):
    from repro_torch.launch import compile as launch_compile
    params = _ref_state()["params"]
    R.save(tmp_path / "ck", 9, jax.tree.map(jnp.asarray, params))
    plan = launch_compile.main(["--small", "--ckpt", str(tmp_path / "ck"),
                                "--out", str(tmp_path / "port.smez")])
    cfg = ref_scale_down(REF_ARCHS["qwen1.5-0.5b"], **SMALL)
    like = ref_build_model(cfg).init_params(jax.random.key(0))
    restored = jax.tree.map(np.asarray, R.restore(tmp_path / "ck", None,
                                                  like))
    ref = _ref_compile_plan(restored, tmp_path / "ref.smez")
    assert plan.to_json() == ref.to_json()
    # the checkpoint's weights, not a fresh init, were planned
    fresh = launch_compile.main(["--small", "--out",
                                 str(tmp_path / "fresh.smez")])
    assert fresh.to_json() != plan.to_json()


def test_train_checkpoint_refused_by_both_compilers(tmp_path, monkeypatch):
    """ROADMAP R9: ``launch/train.py`` saves {"params", "opt"}, both
    compilers restore ``params`` alone (``embed/w``, not
    ``params/embed/w``)."""
    import repro.launch.compile as ref_compile
    from repro_torch.launch import compile as launch_compile
    from repro_torch.launch import train
    ck = tmp_path / "ck"
    train.main(["--arch", "qwen1.5-0.5b", "--small", "--device", "cpu",
                "--steps", "1", "--batch", "2", "--seq", "8",
                "--ckpt-dir", str(ck), "--ckpt-every", "1"])
    assert P.latest_step(ck) == 0
    with pytest.raises(KeyError, match="has no leaf .blocks/slot0"):
        launch_compile.main(["--small", "--ckpt", str(ck), "--out",
                             str(tmp_path / "a.smez")])
    monkeypatch.setattr(sys, "argv", ["compile", "--ckpt", str(ck),
                                      "--out", str(tmp_path / "b.smez")])
    with pytest.raises(KeyError):
        ref_compile.main()
