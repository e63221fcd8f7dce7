"""The port's optimizers (``repro_torch.optim``) against the reference's
``repro.optim``: one update of each on fixed numpy grads and params
(params and state within 1e-6 of the largest magnitude), the schedules
at steps 0-120 and the clipped norm within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as R
from repro_torch import optim as P


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": (rng.standard_normal((6, 5)) * scale
                        ).astype(np.float32)},
            "b": (rng.standard_normal(7) * scale).astype(np.float32),
            "blocks": [{"w": (rng.standard_normal((3, 4)) * scale
                              ).astype(np.float32)} for _ in range(2)]}


def _port(tree):
    return jax.tree.map(torch.as_tensor, tree)


def _close(got, want, tol=1e-6):
    g = jax.tree.leaves(jax.tree.map(lambda t: np.asarray(t), got))
    w = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30)


OPTS = {
    "adamw": lambda m: m.adamw(3e-3),
    "adamw decay": lambda m: m.adamw(m.cosine_schedule(5e-3, 10, 60),
                                     weight_decay=0.01),
    "adamw clip": lambda m: m.adamw(1e-2, clip_norm=0.5),
    "adamw no clip": lambda m: m.adamw(1e-2, weight_decay=0.1,
                                       clip_norm=None),
    "sgd": lambda m: m.sgd(0.1),
    "sgd clip": lambda m: m.sgd(m.linear_warmup(0.1, 4), clip_norm=0.3),
    "lion": lambda m: m.lion(1e-3, weight_decay=0.01),
}


@pytest.mark.parametrize("name", list(OPTS))
def test_update_matches_reference(name):
    params, grads = _tree(0), _tree(1, scale=0.7)
    ref_opt, opt = OPTS[name](R), OPTS[name](P)
    r_state = ref_opt.init(jax.tree.map(jnp.asarray, params))
    state = opt.init(_port(params))
    assert jax.tree.structure(jax.tree.map(np.asarray, r_state)) == \
        jax.tree.structure(jax.tree.map(lambda t: t.numpy(), state))
    rp, pp = jax.tree.map(jnp.asarray, params), _port(params)
    for step, seed in ((0, 1), (1, 2), (7, 3)):
        g = _tree(seed, scale=0.7)
        rp, r_state = ref_opt.update(jax.tree.map(jnp.asarray, g), r_state,
                                     rp, jnp.int32(step))
        pp, state = opt.update(_port(g), state, pp, step)
        _close(pp, rp)
        _close(state, r_state)


def test_schedules_match_reference():
    r_cos, p_cos = R.cosine_schedule(5e-3, 10, 100), \
        P.cosine_schedule(5e-3, 10, 100)
    r_lin, p_lin = R.linear_warmup(3e-3, 7), P.linear_warmup(3e-3, 7)
    for step in range(121):
        for r, p in ((r_cos, p_cos), (r_lin, p_lin)):
            want = float(r(jnp.int32(step)))
            assert abs(float(p(step)) - want) <= 1e-6 * 5e-3


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(4, scale=2.0)
    r, rn = R.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    p, pn = P.clip_by_global_norm(_port(g), max_norm)
    assert abs(float(pn) - float(rn)) <= 1e-6 * float(rn)
    _close(p, r)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_sharded_clip_is_the_whole_trees(shape, max_norm):
    """``clip_by_global_norm`` on every rank's throughput shards of a
    gradient tree (qwen's small tree: matrices split over both axes,
    biases and layer norms over 'model', the final norm whole), the ranks
    threads of this process: on every rank the norm is the whole tree's
    within 1e-6 (each part counted once over the ranks that hold it) and
    the clipped shards are the whole clipped tree's."""
    from repro_torch.configs import ARCHS, scale_down
    from repro_torch.core.integrate import to_torch
    from repro_torch.models.model import init_params
    from repro_torch.parallel import sharding as sh
    from _torch_threads import on_threads
    cfg = scale_down(ARCHS["qwen1.5-0.5b"], n_layers=2, dtype="float32")
    rng = np.random.default_rng(5)
    grads = jax.tree.map(
        lambda a: torch.as_tensor(rng.standard_normal(a.shape, np.float32)
                                  * np.float32(0.05)),
        to_torch(init_params(cfg, np.random.default_rng(0)), "cpu"))
    want, wn = P.clip_by_global_norm(grads, max_norm)

    def rank_main(mesh):
        clipped, gn = P.clip_by_global_norm(sh.place_throughput(grads, mesh),
                                            max_norm)
        return sh.carry_cuts(clipped, sh.place_throughput(grads, mesh)), gn
    for clipped, gn in on_threads(shape, rank_main):
        assert abs(float(gn) - float(wn)) <= 1e-6 * float(wn)
        for got, whole in zip(jax.tree.leaves(clipped),
                              jax.tree.leaves(want)):
            cut = sh.cut_of(got)
            mesh = cut.mesh
            part = whole
            for d, ax in enumerate(cut.spec):
                if ax is not None and mesh.shape[ax] > 1:
                    n = whole.shape[d] // mesh.shape[ax]
                    part = part.narrow(d, mesh.index(ax) * n, n)
            assert torch.allclose(got, part, rtol=1e-6, atol=0)
