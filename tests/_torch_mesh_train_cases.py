"""The MoE family's and MLA's mesh training runs and their checks, shared
by ``test_torch_mesh_train_moe.py`` (mixtral: expert-parallel, and
expert-TP at 6 experts on (1, 4)) and ``test_torch_mesh_train_mla.py``
(deepseek: MLA, shared experts, the dense ``first0``): one gloo world per
file, so that ``--dist loadfile`` runs the two side by side.

Each run is held to the reference's jitted single-device
``make_train_step`` and to the port's own 1x1 step with the dense
family's gates (``test_torch_mesh_train.py``): losses within 1e-5
relative, the pre-clip norm within 1e-6 of the 1x1
step's, the params and each AdamW state tree within 1e-5 of the tree's
largest magnitude (the reference's own mesh step cannot run under this
jax, ROADMAP R12).  The throughput posture reassociates float sums, so a
token whose k-th and (k+1)-th expert probabilities lie that close may
route elsewhere on a mesh: the routes that differ from the 1x1 step's
are counted and printed (a finding, not a gate).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS as REF_ARCHS, scale_down as ref_scale_down
from repro.models import build_model as ref_build_model
from repro.optim import adamw as ref_adamw, cosine_schedule as ref_cos
from repro.train import make_train_step as ref_make_train_step
from repro_torch.configs import ARCHS, scale_down
from repro_torch.convert import from_reference, to_reference
from repro_torch.data import lm_batches
from repro_torch.launch.mesh import Mesh
from repro_torch.models.model import build_model
from repro_torch.tree import flatten

from _torch_mesh_ranks import MOE_TRAIN_RUNS, moe_train_run, world

W = dict(d_model=128, expert_dff=128, dtype="float32")
#: name -> (arch, scale_down overrides)
MODELS = {"mixtral": ("mixtral-8x7b", dict(W, n_layers=2)),
          "mixtral-e6": ("mixtral-8x7b", dict(W, n_layers=2, n_experts=6)),
          "deepseek": ("deepseek-v2-lite-16b", W)}


def runs(names) -> tuple:
    """The runs of :data:`MOE_TRAIN_RUNS` of the models ``names``."""
    return tuple(r for r in MOE_TRAIN_RUNS if r[0] in names)


def ids(run) -> str:
    name, shape, micro = run
    return f"{name}-{shape[0]}x{shape[1]}-micro{micro}"


def _rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


def _tree_err(got, want):
    """The largest leaf difference over the tree's largest magnitude."""
    got, want = flatten(got), flatten(want)
    assert list(got) == list(want)
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    return max(float(np.abs(np.asarray(g, np.float64)
                            - np.asarray(w, np.float64)).max())
               for g, w in zip(got.values(), want.values())) / top


def _ref_run(ref_api, dense, batches, micro):
    opt = ref_adamw(ref_cos(3e-3, 1, 4), weight_decay=0.01)
    step = jax.jit(ref_make_train_step(ref_api.train_loss, opt, micro))
    p = jax.tree.map(jnp.asarray, dense)
    state = opt.init(p)
    losses = []
    for i, b in enumerate(batches):
        p, state, loss = step(p, state, jnp.int32(i),
                              jax.tree.map(jnp.asarray, b))
        losses.append(float(loss))
    return dict(losses=losses, params=p, m=state["m"], v=state["v"])


def train_world(tmp, names):
    """({"ref"|"port": this process's single-device runs per (model,
    micro), "one": the port's 1x1-mesh runs at micro 1 (not for the
    expert-TP variant), "n_slots"}, every rank's results) of the models
    ``names``: four gloo ranks train :func:`runs` (the ``"train_moe"``
    job) while this process runs the reference's and the port's
    single-device steps and the port's step on the 1x1 mesh."""
    models, refs = {}, {}
    for name in names:
        arch, over = MODELS[name]
        cfg = ref_scale_down(REF_ARCHS[arch], **over)
        ref_api = ref_build_model(cfg)
        dense = jax.tree.map(np.asarray, ref_api.init_params(
            jax.random.key(3)))
        it = lm_batches(cfg.vocab, 8, 32, seed=4)
        batches = [next(it) for _ in range(2)]
        api = build_model(scale_down(ARCHS[arch], **over), device="cpu")
        models[name] = (api, from_reference(dense, device="cpu"), batches)
        refs[name] = (ref_api, dense, len(cfg.pattern))
    wanted = sorted({(name, micro) for name, _, micro in runs(names)})

    def local():
        # one intra-op thread: the CPU's parallel accumulation of the
        # embedding's gradient (an index_put over repeated ids) is not
        # deterministic, and the 1x1-mesh check is bitwise
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return local_runs()
        finally:
            torch.set_num_threads(threads)

    def local_runs():
        ref, port, one = {}, {}, {}
        for name, micro in wanted:
            ref_api, dense, _ = refs[name]
            api, params, batches = models[name]
            ref[(name, micro)] = _ref_run(ref_api, dense, batches, micro)
            port[(name, micro)] = moe_train_run(api, params, batches, micro)
            if micro == 1 and name != "mixtral-e6":
                one[name] = moe_train_run(api, params, batches, 1,
                                          Mesh(1, 1, device="cpu"))
        return dict(ref=ref, port=port, one=one,
                    n_slots={k: v[2] for k, v in refs.items()})
    return world(tmp, dict(kind="train_moe", models=models,
                           runs=runs(names)), local)


def check_reference(world, run):
    """Every rank's losses within 1e-5 of the reference's single-device
    step, and its gathered params, m and v within 1e-5 of each tree's
    largest magnitude."""
    local, ranks = world
    name, _, micro = run
    want = local["ref"][(name, micro)]
    for out in ranks:
        got = out["train"][run]
        for a, b in zip(got["losses"], want["losses"]):
            assert _rel(a, b) <= 1e-5, (a, b)
        for k in ("params", "m", "v"):
            err = _tree_err(to_reference(got[k], local["n_slots"][name]),
                            want[k])
            assert err <= 1e-5, (k, err)


def check_one_by_one(world, run):
    """Against the port's own single-device step: the same tolerances,
    and each step's pre-clip global norm within 1e-6."""
    local, ranks = world
    want = local["port"][run[0], run[2]]
    for out in ranks:
        got = out["train"][run]
        for a, b in zip(got["losses"], want["losses"]):
            assert _rel(a, b) <= 1e-5, (a, b)
        for a, b in zip(got["norms"], want["norms"]):
            assert _rel(a, b) <= 1e-6, (a, b)
        for k in ("params", "m", "v"):
            assert _tree_err(got[k], want[k]) <= 1e-5, k


def check_loss_bitwise(world, names):
    """The returned loss (summed over 'data') and the norm are the same
    bits on every rank, in every run; no rank imported jax or the
    reference package."""
    _, ranks = world
    for run in runs(names):
        first = ranks[0]["train"][run]
        for out in ranks[1:]:
            got = out["train"][run]
            assert all(torch.equal(a, b) for a, b in
                       zip(got["losses"], first["losses"])), run
            assert got["norms"] == first["norms"], run
    assert all(out["jax"] == [] for out in ranks)


def check_mesh_none(world, name):
    """On the 1x1 mesh every collective is the identity: the losses,
    norms, routes, params, m and v equal ``mesh=None``'s bitwise."""
    local, _ = world
    got, want = local["one"][name], local["port"][(name, 1)]
    assert all(torch.equal(a, b) for a, b in zip(got["losses"],
                                                 want["losses"]))
    assert got["norms"] == want["norms"]
    assert all(torch.equal(a, b) for a, b in zip(got["routes"],
                                                 want["routes"]))
    for k in ("params", "m", "v"):
        g, w = flatten(got[k]), flatten(want[k])
        assert list(g) == list(w)
        assert all(torch.equal(g[n], w[n]) for n in w), k


def route_flips(world, names):
    """Rank 0's routes (its 'data' rows) against the 1x1 step's at one
    microbatch: one [rows, S, k] record per MoE layer per step on every
    rank; the ``(token, k)`` entries that differ are printed per run."""
    local, ranks = world
    for run in runs(names):
        name, (data, _), micro = run
        if micro != 1:
            continue
        want = local["port"][(name, 1)]["routes"]
        n_moe = len(want) // 2
        assert n_moe == {"mixtral": 2, "mixtral-e6": 2, "deepseek": 1}[name]
        flips = total = 0
        for r, out in enumerate(ranks):
            got = out["train"][run]["routes"]
            assert len(got) == len(want), run
            rows = want[0].shape[0] // data
            d = r // (4 // data)
            for g, w in zip(got, want):
                part = w[d * rows:(d + 1) * rows]
                assert g.shape == part.shape, run
                if r == 0:
                    flips += int((g != part).sum())
                    total += g.numel()
        print(f"route flips {ids(run)}: rank 0 {flips} of {total} "
              f"(token, k) routes differ from 1x1's over 2 steps")


def check_quarter(world, names):
    """Each rank's params + m + v are a quarter of the 1x1 bytes (and a
    little more: the router and the final norm stay whole) on every
    mesh, expert-parallel or expert-TP."""
    local, ranks = world
    for run in runs(names):
        whole = local["port"][run[0], run[2]]["bytes"]
        for out in ranks:
            frac = out["train"][run]["bytes"] / whole
            assert 0.25 <= frac < 0.27, (run, frac)


def check_expert_cuts(world, names):
    """The runs' expert stacks are cut by their throughput specs:
    expert-parallel where the experts divide 'model' (4 on every mesh),
    expert-TP on F where they do not (mixtral-e6's 6 on (1, 4)); each
    rank holds its shard of ``wi`` and ``wo``."""
    _, ranks = world
    want = {"parallel": (("model", "data", None), ("model", None, "data")),
            "tp": ((None, "data", "model"), (None, "model", "data"))}
    for run in runs(names):
        kind = "tp" if run[0] == "mixtral-e6" else "parallel"
        for out in ranks:
            got = out["experts"][run]
            assert (got["wi"][0], got["wo"][0]) == want[kind], run
            e, f = (6, 128) if kind == "tp" else (4, 128)
            data, model = run[1]
            if kind == "tp":
                assert got["wi"][1] == (e, 128 // data, f // model)
                assert got["wo"][1] == (e, f // model, 128 // data)
            else:
                assert got["wi"][1] == (e // model, 128 // data, f)
                assert got["wo"][1] == (e // model, f, 128 // data)
