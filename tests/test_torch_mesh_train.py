"""Mesh training of the dense family under the throughput posture on
``torch.distributed`` ranks, held to the reference's single-device step.

The reference's own mesh step cannot run under this jax (ROADMAP R12:
``tests/test_system.py::test_multidevice_sharded_train_step`` stops in
its scan, and at one microbatch in the embed gather), so the port's step
on (2, 2), (4, 1) and (1, 4) is held to the reference's single-device
``make_train_step`` (jitted) and to the port's own 1x1 step.  The
throughput posture reassociates float sums (FSDP's reduce-scatter, the
row-parallel and vocab-parallel all-reduces), so the comparison has a
tolerance: losses within 1e-5 relative, the params and each AdamW state
tree within 1e-5 of the tree's largest magnitude (``test_torch_train.py``'s
rule, per tree: the key bias's gradient is rounding noise that Adam turns
into steps of order lr), the pre-clip norm within 1e-6 of the 1x1 step's.

One module fixture spawns four ``gloo`` ranks on the CPU
(``_torch_mesh_ranks.world``, the ``"train"`` job) that train qwen's
smoke config at 2 layers (64 wide, f32) for 2 AdamW steps (weight decay
0.01, clip 1.0, cosine) on a global batch of 8 x 32, at 1 and 2
microbatches, while this process runs the reference's and the port's
single-device steps.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS, scale_down as ref_scale_down
from repro.models import build_model as ref_build_model
from repro.optim import adamw as ref_adamw, cosine_schedule as ref_cos
from repro.train import make_train_step as ref_make_train_step
from repro_torch.configs import ARCHS, scale_down
from repro_torch.convert import from_reference, to_reference
from repro_torch.core.integrate import to_torch
from repro_torch.data import lm_batches
from repro_torch.models.model import build_model, init_params
from repro_torch.tree import flatten

from _torch_mesh_ranks import MESHES, TRAIN_RUNS, train_run, world
from _torch_small import small_models

SMOKE = dict(n_layers=2, dtype="float32")
MICROS = (1, 2)


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


@pytest.fixture(scope="module", name="world")
def _world(tmp_path_factory):
    """({"ref"|"port": this process's single-device runs per micro,
    "params": the params they start from}, every rank's results)."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    cfg = ref_scale_down(REF_ARCHS["qwen1.5-0.5b"], **SMOKE)
    ref_api = ref_build_model(cfg)
    dense = jax.tree.map(np.asarray, ref_api.init_params(jax.random.key(3)))
    it = lm_batches(cfg.vocab, 8, 32, seed=4)
    batches = [next(it) for _ in range(2)]
    api = build_model(scale_down(ARCHS["qwen1.5-0.5b"], **SMOKE),
                      device="cpu")
    params = from_reference(dense, device="cpu")
    rec_cfg = scale_down(ARCHS["xlstm-1.3b"], dtype="float32")
    recurrent = (build_model(rec_cfg, device="cpu"),
                 to_torch(init_params(rec_cfg, np.random.default_rng(0)),
                          "cpu"),
                 next(lm_batches(rec_cfg.vocab, 8, 32, seed=4)))

    def local():
        ref, port = {}, {}
        for micro in MICROS:
            opt = ref_adamw(ref_cos(3e-3, 1, 4), weight_decay=0.01)
            step = jax.jit(ref_make_train_step(ref_api.train_loss, opt,
                                               micro))
            p = jax.tree.map(jnp.asarray, dense)
            state = opt.init(p)
            losses = []
            for i, b in enumerate(batches):
                p, state, loss = step(p, state, jnp.int32(i),
                                      jax.tree.map(jnp.asarray, b))
                losses.append(float(loss))
            ref[micro] = dict(losses=losses, params=p, m=state["m"],
                              v=state["v"])
            port[micro] = train_run(api, params, batches, micro)
        return dict(ref=ref, port=port, params=params)
    job = dict(kind="train", api=api, params=params, batches=batches,
               packed=small_models().port_packed, recurrent=recurrent)
    return world(tmp, job, local)


def _ids(run):
    shape, micro = run
    return f"{shape[0]}x{shape[1]}-micro{micro}"


@pytest.mark.parametrize("run", TRAIN_RUNS, ids=_ids)
def test_mesh_step_matches_reference_single_device(world, run):
    """Every rank's losses within 1e-5 of the reference's single-device
    step, and its gathered params, m and v within 1e-5 of each tree's
    largest magnitude."""
    local, ranks = world
    want = local["ref"][run[1]]
    for out in ranks:
        got = out["train"][run]
        for a, b in zip(got["losses"], want["losses"]):
            assert _rel(a, b) <= 1e-5, (a, b)
        for k in ("params", "m", "v"):
            err = _tree_err(to_reference(got[k]), want[k])
            assert err <= 1e-5, (k, err)


@pytest.mark.parametrize("run", TRAIN_RUNS, ids=_ids)
def test_mesh_step_matches_port_one_by_one(world, run):
    """Against the port's own 1x1 step: the same tolerances, and each
    step's pre-clip global norm within 1e-6."""
    local, ranks = world
    want = local["port"][run[1]]
    for out in ranks:
        got = out["train"][run]
        for a, b in zip(got["losses"], want["losses"]):
            assert _rel(a, b) <= 1e-5, (a, b)
        for a, b in zip(got["norms"], want["norms"]):
            assert _rel(a, b) <= 1e-6, (a, b)
        for k in ("params", "m", "v"):
            assert _tree_err(got[k], want[k]) <= 1e-5, k


def test_loss_bitwise_on_every_rank(world):
    """The returned loss (summed over 'data') and the norm are the same
    bits on every rank, in every run."""
    _, ranks = world
    for run in TRAIN_RUNS:
        first = ranks[0]["train"][run]
        for out in ranks[1:]:
            got = out["train"][run]
            assert all(torch.equal(a, b) for a, b in
                       zip(got["losses"], first["losses"])), run
            assert got["norms"] == first["norms"], run


def test_each_rank_holds_its_shards_and_they_round_trip(world):
    """Each rank holds only its throughput shard of every split leaf (the
    matrices over both axes, biases and layer norms over 'model'), and
    of ``m`` and ``v``: about a quarter of the 1x1 bytes on every mesh;
    the shards gathered back give every leaf bitwise."""
    local, ranks = world
    params = flatten(local["params"])
    whole = {k: tuple(t.shape) for k, t in params.items()}
    for out in ranks:
        for shape in MESHES:
            got = out["shards"][shape]
            back = flatten(got["back"])
            assert all(torch.equal(back[k], params[k]) for k in params)
            shapes = got["shapes"]
            assert shapes["embed/w"][0] * shape[1] == whole["embed/w"][0]
            q = shapes["blocks/0/mix/q/w"]
            assert q[0] * shape[0] == whole["blocks/0/mix/q/w"][0]
            assert q[1] * shape[1] == whole["blocks/0/mix/q/w"][1]
            o = shapes["blocks/0/mix/o/w"]
            assert (o[0] * shape[1], o[1] * shape[0]) == \
                whole["blocks/0/mix/o/w"]
            assert shapes["final_norm/w"] == whole["final_norm/w"]
        for shape in MESHES:
            frac = out["train"][(shape, 1)]["bytes"] / \
                local["port"][1]["bytes"]
            assert 0.25 <= frac < 0.27, (shape, frac)


def _sums(xs):
    """Every f32 sum of ``xs`` a backend may form: a fold in any order,
    and for four terms the sum of two pairs (the scales' mean is a sum
    over the group, in the backend's order)."""
    out = set()
    for perm in itertools.permutations(xs):
        acc = np.float32(0)
        for x in perm:
            acc = np.float32(acc + x)
        out.add(acc)
        if len(perm) == 4:
            out.add(np.float32(np.float32(perm[0] + perm[1])
                               + np.float32(perm[2] + perm[3])))
    return sorted(out)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_ef_allreduce_on_data_groups(world, shape):
    """``ef_allreduce`` over a 'data' group on the first step's gradient
    shards equals the reference's formula in numpy over the ranks of the
    group: every rank's codes summed as int32 (bitwise), times the mean
    of the scales, over the group's size (within 1 ulp of the formula
    with the scales summed in one of the orders a backend may take); the
    residual is this rank's own, bitwise."""
    _, ranks = world
    data, model = shape
    for r, out in enumerate(ranks):
        group = [d * model + r % model for d in range(data)]
        ef = out["ef"][shape]
        g = {i: flatten(ranks[i]["ef"][shape]["g"]) for i in group}
        deq, resid = flatten(ef["deq"]), flatten(ef["resid"])
        for k in deq:
            codes, scales = [], []
            for i in group:
                x = g[i][k].numpy().astype(np.float32)
                s = np.float32(max(np.abs(x).max(), np.float32(1e-12))
                               / np.float32(127.0))
                q = np.clip(np.round(x / s), -127, 127).astype(np.int8)
                codes.append(q)
                scales.append(s)
                if i == r:
                    want_r = x - q.astype(np.float32) * s
            summed = np.sum(np.stack(codes).astype(np.int32), axis=0)
            got = deq[k].numpy()
            close = []
            for total in _sums(scales):
                scale = np.float32(total / np.float32(data))
                want = summed.astype(np.float32) * scale / np.float32(data)
                assert np.array_equal(np.rint(got * data / scale)
                                      .astype(np.int32), summed), k
                close.append(bool(np.all(np.abs(got - want) <= np.spacing(
                    np.abs(want).astype(np.float32)))))
            assert any(close), k
            assert np.array_equal(resid[k].numpy(), want_r), k


def test_packed_tree_and_other_family_refused(world):
    """On (2, 2) a packed tree raises ValueError before any collective,
    and a recurrent model (xlstm's smoke config) names the ROADMAP item
    (the MoE family and MLA train on a mesh:
    ``test_torch_mesh_train_moe.py``); no rank imported jax or the
    reference package."""
    _, ranks = world
    for out in ranks:
        assert "SME-packed" in out["refused"]["packed"]
        msg = out["refused"]["recurrent"]
        assert "the recurrent family waits for ROADMAP §1, open item 1" \
            in msg, msg
        assert "mesh training covers the decoder-only text families" in msg
        assert out["jax"] == []
