"""Mesh serving of the encoder-decoder family on ``torch.distributed``
ranks: whisper-medium bit-identical to the 1x1 mesh (the contract of
``test_torch_mesh.py``).

One module fixture spawns two worlds of four ``gloo`` ranks on the CPU
side by side (``_torch_mesh_ranks.worlds``: no jax, one thread each) that
serve :data:`RUNS` while this process serves the same requests on the
1x1 mesh: dense and v2 on (2, 2), (4, 1) and (1, 4), and v3 with
self-speculative decode on (2, 2).  Every run admits one request per
window behind its own zero frames, and the second wave reuses slots of
the first: slot 1 takes a 6-token source after a 24-token one, so its
cross K/V hold the earlier request's keys past the new source (ROADMAP
R6), which the decode steps must not attend.  Whisper at the widths of
``test_torch_encdec_engine.py`` (2 + 2 layers, 128 wide, 4 heads of 32,
f32) with a vocab of 700: the embedding's rows split at 'model' 2 and 4,
and the packed head's 6 column tiles (5.5 in use) split at 'model' 2 and
stay whole at 4 (``place_tree`` splits whole tiles only where the count
divides).  The port's own seeded weights, packed for v1-v3 by the port's
converter.  The reference engine cannot serve on a mesh (ROADMAP R1);
``test_torch_encdec_engine.py`` holds the 1x1 engine to the reference's
model-API loop.  The launcher's ``--mesh 2,2`` runs in a subprocess.
"""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_mesh_ranks import MESHES, prefill_logits, serve, worlds
from repro_torch.configs import ARCHS, scale_down
from repro_torch.core.integrate import convert_params_to_sme, to_torch
from repro_torch.launch.mesh import Mesh
from repro_torch.models.model import build_model, init_params
from repro_torch.parallel.sharding import cache_sharding, shard_shape

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "whisper-medium"
#: ``test_torch_encdec_engine.py``'s widths; a vocab of 5.5 column tiles
WHISPER = dict(d_model=128, d_ff=256, head_dim=32, n_heads=4, n_kv_heads=4,
               vocab=700, n_layers=2, dtype="float32")
#: backend -> the meshes it serves on
RUNS = {None: MESHES, "v2": MESHES, "v3": ((2, 2),)}
#: the worlds, side by side: their backends
WORLDS = ((None, "v3"), ("v2",))
CASES = [(b, shape) for b, shapes in RUNS.items() for shape in shapes]


def _models():
    """(api, backend -> params): the port's seeded weights (the embedding
    scaled to 0.05, as ``_torch_small``'s), dense and packed."""
    cfg = scale_down(ARCHS[ARCH], **WHISPER)
    tree = init_params(cfg, np.random.default_rng(3))
    tree["embed"]["w"] = tree["embed"]["w"] * np.float32(0.05)
    packed = convert_params_to_sme(tree, squeeze=1, backend="all",
                                   device="cpu")
    return build_model(cfg, device="cpu"), {None: to_torch(tree, "cpu"),
                                            "v2": packed, "v3": packed}


def _name(group):
    return "-".join(b or "dense" for b in group)


def _case_id(case):
    b, shape = case
    return f"{b or 'dense'}-{shape[0]}x{shape[1]}"


@pytest.fixture(scope="module", name="world")
def _world(tmp_path_factory):
    """(the 1x1 results of this process, {world: every rank's results},
    the api)."""
    tmp = tmp_path_factory.mktemp("mesh_encdec")
    api, params = _models()

    def local():
        ref = {"tokens": {}, "logits": {}}
        for b, p in params.items():
            ref["tokens"][b] = serve(api, p, b)[0]
            ref["logits"][b] = prefill_logits(api, p)
        return ref
    jobs = {_name(group): dict(
        kind="family", families={"encdec": (api, {b: params[b]
                                                  for b in group})},
        runs={"encdec": {b: RUNS[b] for b in group}})
        for group in WORLDS}
    ref, ranks = worlds(tmp, jobs, local)
    return ref, ranks, api


def _ranks(world, backend):
    group = next(g for g in WORLDS if backend in g)
    return world[1][_name(group)]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_encdec_mesh_tokens_bit_identical(world, case):
    """One request per window, a temperature row, a slot reused by a
    shorter source (and v3's spec decode) on a mesh == the 1x1 mesh,
    token for token, on every rank."""
    backend, shape = case
    for r, out in enumerate(_ranks(world, backend)):
        got = out["tokens"][("encdec", backend, shape)]
        assert got == world[0]["tokens"][backend], (r, got)
        eng = out["engine"][("encdec", backend, shape)]
        assert (eng["spec_rounds"] > 0) == (backend == "v3"), eng


@pytest.mark.parametrize("backend", list(RUNS), ids=lambda b: b or "dense")
def test_encdec_mesh_prefill_logits_bitwise(world, backend):
    """16 tokens over 16 random frames: the f32 logits on (2, 2) equal
    the 1x1 logits bitwise on every rank."""
    for out in _ranks(world, backend):
        assert torch.equal(out["logits"][("encdec", backend)],
                           world[0]["logits"][backend])


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_encdec_caches_shard_by_the_rule(world, case):
    """Every cache leaf on every rank has the shard shape of
    ``cache_sharding(exact=True)``: the self and cross K/V [slots, s_max,
    heads, hd] with their slot rows over 'data' and heads over 'model'
    (on (2, 2) 2 rows and 2 heads, on (1, 4) one head of 4, on (4, 1)
    one row); and the slot that took a shorter source holds stale cross
    keys past it on the rank that has the slot."""
    backend, shape = case
    key = ("encdec", backend, shape)
    ranks = _ranks(world, backend)
    meta = world[2].init_cache(4, 64, device="meta")
    for rank, out in enumerate(ranks):
        mesh = Mesh(*shape, rank=rank, device="cpu", groups={"world": None})
        specs = cache_sharding(mesh, meta, 4, exact=True)
        want = [{f"{a}/{b}": shard_shape(mesh, sp[a][b], t.shape)
                 for a, kv in lay.items() for b, t in kv.items()}
                for lay, sp in zip(meta, specs)]
        assert out["states"][key] == want, rank
    rows, heads = 4 // shape[0], 4 // shape[1]
    assert ranks[0]["states"][key][0] == {
        f"{a}/{b}": (rows, 64, heads, 32) for a in ("self", "cross")
        for b in "kv"}
    assert {s for out in ranks for s in out["stale"][key]} == {1}


@pytest.mark.parametrize("backend", list(RUNS), ids=lambda b: b or "dense")
def test_encdec_weights_split_as_the_spec_says(world, backend):
    """On (2, 2) the embedding's vocab rows split and so does every
    weight whose output dim does: the dense head's columns or the packed
    head's 6 column tiles (3 per rank); the dense cross q/k/v/o, but no
    packed weight of one column tile (128 wide); the MLP's ``wi`` (2
    tiles) either way."""
    split = _ranks(world, backend)[0]["split"][("encdec", backend)]
    assert "/embed/w" in split
    assert "/lm_head/w" in split
    assert any(n.endswith("mlp/wi/w") for n in split), split
    for w in ("q", "k", "v", "o"):
        assert any(n.endswith(f"cross/{w}/w") for n in split) == (
            backend is None), (w, split)


def test_packed_head_splits_on_two_and_stays_whole_on_four():
    """``place_tree`` cuts the packed head's 6 column tiles 3 + 3 over a
    'model' axis of 2 (the second rank's last tile ragged: 316 columns)
    and keeps all 6 whole on each rank of a 'model' axis of 4, where 4
    does not divide them; the embedding's 700 rows split 350 / 175."""
    from repro_torch.parallel.sharding import place_tree, split_of
    _, params = _models()
    tree = {"lm_head": params["v2"]["lm_head"], "embed": params[None]["embed"]}
    for model, cols, rows in ((2, (384, 316), 350), (4, None, 175)):
        for rank in range(model):
            mesh = Mesh(1, model, rank=rank, device="cpu",
                        groups={"world": None})
            placed = place_tree(tree, mesh)
            head = placed["lm_head"]["w"]
            if cols is None:
                assert split_of(head) is None
                assert head["sme_scale"].shape[-1] == 700
            else:
                assert head["sme_scale"].shape[-1] == cols[rank]
                assert head["sme_codes"].shape[1] == 3
            assert placed["embed"]["w"].shape[0] == rows


def test_encdec_mesh_nothing_sums(world):
    """Every rank sampled rank 0's ids itself, no float all_reduce or
    reduce_scatter ran while serving, v3 drafted, and no rank imported
    jax or the reference package."""
    for name, ranks in world[1].items():
        for out in ranks:
            assert (out["drafts"] > 0) == ("v3" in name)
            assert out["mismatches"] == 0
            assert out["summed"] == []
            assert out["jax"] == []


def _reqs(text):
    return re.findall(r"^req \d+: .*$", text, re.M)


def test_launcher_mesh_2x2_whisper(capsys):
    """``launch/serve.py --arch whisper-medium --mesh 2,2 --device cpu``
    prints the 1x1 run's tokens."""
    from repro_torch.launch.serve import main
    argv = ["--arch", ARCH, "--small", "--device", "cpu", "--sme",
            "--backend", "v2", "--requests", "3", "--max-new", "4"]
    main(argv)
    want = _reqs(capsys.readouterr().out)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv, "--mesh",
         "2,2"], capture_output=True, text=True, cwd=ROOT, env=env,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "mesh 2x2 over gloo: 4 ranks" in proc.stdout
    assert _reqs(proc.stdout) == want and len(want) == 3
