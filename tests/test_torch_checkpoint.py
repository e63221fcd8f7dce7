"""Checkpoints and fault tolerance of the port (``repro_torch.train``)
against the reference's ``repro.train``: a reference-written checkpoint
(params and AdamW state) restores bitwise in the port and the reverse;
atomic saves; the manager's keep/collect and async saves; shape checks;
the elastic reshard on rank threads (``_torch_threads``: a (2, 2) save
of throughput shards is the one-process save of the logical tree, and
restores onto (1, 4) and (4, 1) as ``place_throughput``'s shards; a
step resumed on another mesh within 1e-5 of the reference's; the
manager on a mesh);
``retry_transient``, ``StragglerDetector`` and ``run_resumable`` as
``test_substrate.py`` holds the reference's; ``compile --ckpt`` of a
reference-written params checkpoint plans byte-equal to the reference's
compiler; and ROADMAP R9: a ``launch/train.py`` checkpoint is refused by
both compilers."""
import dataclasses
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
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import sharding as sh
from repro_torch.tree import flatten
from repro_torch.train import checkpoint as P
from repro_torch.train.fault import (Heartbeat, StragglerDetector,
                                     TransientError, retry_transient,
                                     run_resumable)

from _torch_threads import on_threads


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


# ------------------------------------------------- checkpoints on a mesh
def _port_state():
    """:func:`_ref_state` in the port's layout, as CPU tensors:
    {"params", "opt": {"m", "v"}}."""
    tree = _ref_state()
    return {"params": from_reference(tree["params"], "cpu"),
            "opt": {k: from_reference(v, "cpu")
                    for k, v in tree["opt"].items()}}


def _same_files(a, b):
    """Two checkpoint steps hold the same arrays bitwise (names, dtypes,
    values) and the same manifest."""
    fa, fb = np.load(a / "arrays.npz"), np.load(b / "arrays.npz")
    assert sorted(fa.files) == sorted(fb.files)
    for k in fa.files:
        x, y = fa[k], fb[k]
        assert x.dtype == y.dtype and np.array_equal(x, y), k
    assert (a / "manifest.json").read_text() == \
        (b / "manifest.json").read_text()


def _shards_equal(got, tree, mesh):
    """Each leaf of ``got`` is ``place_throughput``'s shard of ``tree`` on
    ``mesh`` bitwise, with its Cut."""
    want = flatten(sh.place_throughput(tree, mesh))
    got = flatten(got)
    assert list(got) == list(want)
    for k, w in want.items():
        assert sh.cut_of(got[k]) == sh.cut_of(w), k
        assert torch.equal(got[k], w), k


def test_mesh_save_is_the_logical_tree_and_restores_onto_other_meshes(
        tmp_path):
    """A (2, 2) save of qwen's small params and AdamW state, each rank
    holding its throughput shards: rank 0 writes the same files, bitwise,
    as a one-process save of the whole tree, and the reference's
    ``restore`` reads them; restored onto (1, 4) and (4, 1) (``like`` the
    (2, 2) shards: whole shapes from their Cuts), each rank's shards equal
    ``place_throughput`` of the whole tree bitwise, each with its Cut; a
    checkpoint written by the reference's ``save`` restores onto (2, 2)
    the same way; shapes and names are checked."""
    tree = _port_state()
    P.save(tmp_path / "one", 5, tree, extra={"a": 1})

    def save22(mesh):
        placed = sh.place_throughput(tree, mesh)
        P.save(tmp_path / "mesh", 5, placed, extra={"a": 1}, mesh=mesh)
        return placed
    like = on_threads((2, 2), save22)[0]
    _same_files(tmp_path / "one/step_00000005",
                tmp_path / "mesh/step_00000005")
    _equal(R.restore(tmp_path / "mesh", None,
                     jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)),
           jax.tree.map(lambda t: t.numpy(), tree))
    R.save(tmp_path / "ref", 2, jax.tree.map(
        lambda t: jnp.asarray(t.numpy()), tree))
    for src, shape in (("mesh", (1, 4)), ("mesh", (4, 1)), ("ref", (2, 2))):
        def restore(mesh):
            got = P.restore(tmp_path / src, None, like, mesh=mesh)
            _shards_equal(got, tree, mesh)
            return len(flatten(got))
        assert on_threads(shape, restore) == [len(flatten(tree))] * 4
    mesh = Mesh(1, 1, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        P.restore(tmp_path / "mesh", 5, {"params": {"embed": {
            "w": torch.zeros(3, 3)}}}, mesh=mesh)
    with pytest.raises(KeyError, match="has no leaf"):
        P.restore(tmp_path / "mesh", 5, {"x": torch.zeros(1)}, mesh=mesh)
    # shards of a mesh of several ranks are refused without their mesh
    with pytest.raises(ValueError, match="save it with mesh="):
        P.save(tmp_path / "bad", 1, like)


def test_step_resumed_on_another_mesh_matches_reference(tmp_path):
    """One AdamW step on (2, 2), its params and state saved through the
    mesh checkpoint, restored onto (1, 4), one more step there: within
    1e-5 of the reference's two single-device steps (losses relative,
    params, m and v of each tree's largest magnitude) and the pre-clip
    norm within 1e-6 of the port's own."""
    from repro.optim import cosine_schedule as ref_cos
    from repro.train import make_train_step as ref_make_train_step
    from repro_torch.data import lm_batches
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw, cosine_schedule, global_norm
    from repro_torch.configs import ARCHS, scale_down
    from repro_torch.train import make_train_step
    smoke = dict(n_layers=2, dtype="float32")
    cfg = ref_scale_down(REF_ARCHS["qwen1.5-0.5b"], **smoke)
    ref_api = ref_build_model(cfg)
    dense = jax.tree.map(np.asarray, ref_api.init_params(jax.random.key(3)))
    it = lm_batches(cfg.vocab, 8, 32, seed=4)
    batches = [next(it) for _ in range(2)]
    opt = ref_adamw(ref_cos(3e-3, 1, 4), weight_decay=0.01)
    step = jax.jit(ref_make_train_step(ref_api.train_loss, opt, 1))
    p = jax.tree.map(jnp.asarray, dense)
    state, want = opt.init(p), []
    for i, b in enumerate(batches):
        p, state, loss = step(p, state, jnp.int32(i),
                              jax.tree.map(jnp.asarray, b))
        want.append(float(loss))
    api = build_model(scale_down(ARCHS["qwen1.5-0.5b"], **smoke), "cpu")
    params = from_reference(dense, "cpu")

    def port_step(mesh, norms):
        inner = adamw(cosine_schedule(3e-3, 1, 4), weight_decay=0.01)

        def update(grads, st, prm, i):
            norms.append(float(global_norm(grads)))
            return inner.update(grads, st, prm, i)
        return inner, make_train_step(
            api.train_loss, dataclasses.replace(inner, update=update),
            mesh=mesh)
    norms_1x1 = []
    inner, one = port_step(None, norms_1x1)
    p1, s1 = params, inner.init(params)
    for i, b in enumerate(batches):
        p1, s1, _ = one(p1, s1, i, b)

    def first(mesh):
        norms = []
        inner, stp = port_step(mesh, norms)
        prm = sh.place_throughput(params, mesh)
        prm, st, loss = stp(prm, inner.init(prm), 0, batches[0])
        P.save(tmp_path, 0, {"params": prm, "opt": st}, mesh=mesh)
        return float(loss), norms
    firsts = on_threads((2, 2), first)
    like = {"params": params, "opt": {"m": params, "v": params}}

    def second(mesh):
        norms = []
        _, stp = port_step(mesh, norms)
        got = P.restore(tmp_path, 0, like, mesh=mesh)
        prm, st, loss = stp(got["params"], got["opt"], 1, batches[1])
        return (float(loss), norms, sh.gather_throughput(prm, mesh),
                {k: sh.gather_throughput(v, mesh) for k, v in st.items()})
    for (l0, n0), (l1, n1, prm, st) in zip(firsts,
                                            on_threads((1, 4), second)):
        for got, ref in zip((l0, l1), want):
            assert abs(got - ref) <= 1e-5 * abs(ref), (got, ref)
        for got, ref in zip(n0 + n1, norms_1x1):
            assert abs(got - ref) <= 1e-6 * abs(ref), (got, ref)
        for got, ref in ((prm, p), (st["m"], state["m"]),
                         (st["v"], state["v"])):
            got = to_reference(got)
            top = max(float(np.abs(np.asarray(r)).max())
                      for r in jax.tree.leaves(ref))
            err = max(float(np.abs(np.asarray(g, np.float64)
                                   - np.asarray(r, np.float64)).max())
                      for g, r in zip(jax.tree.leaves(got),
                                      jax.tree.leaves(ref)))
            assert err <= 1e-5 * top, err


def test_checkpoint_manager_on_a_mesh(tmp_path):
    """``CheckpointManager`` on (2, 2) rank threads, saving every 2 steps
    asynchronously and keeping 2: rank 0 alone writes and collects, the
    steps kept are the one-process manager's, and ``restore_latest(mesh=)``
    gives every rank its shards of the last tree saved."""
    trees = {s: {"params": {"embed": {"w": torch.full((8, 4), float(s))},
                            "final_norm": {"w": torch.arange(4.0) + s}}}
             for s in range(7)}
    mgr = P.CheckpointManager(tmp_path, every=2, keep=2, async_save=True)

    def rank_main(mesh):
        saved = [s for s in range(7) if mgr.maybe_save(
            s, sh.place_throughput(trees[s], mesh), mesh=mesh)]
        got = mgr.restore_latest(trees[0], mesh=mesh)
        _shards_equal(got, trees[6], mesh)
        return saved
    assert on_threads((2, 2), rank_main) == [[0, 2, 4, 6]] * 4
    mgr._gc()
    assert sorted(p.name for p in tmp_path.glob("step_????????")) == \
        ["step_00000004", "step_00000006"]


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
