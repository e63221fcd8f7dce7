"""Mesh serving of the recurrent family on ``torch.distributed`` ranks:
jamba-v0.1-52b (Mamba, an attention slot, MoE MLPs) and xlstm-1.3b
(mLSTM and sLSTM) bit-identical to the 1x1 mesh (the contract of
``test_torch_mesh.py``).

One module fixture spawns four worlds of four ``gloo`` ranks on the CPU
side by side (``_torch_mesh_ranks.worlds``: no jax, one thread each; a
rank mostly waits on its gathers), that serve :data:`RUNS` while this
process serves the same requests on the 1x1 mesh: each arch dense and v2
on (2, 2), (4, 1) and (1, 4), and v3 with self-speculative decode on (2,
2), every run with chunked prefill (chunks of 16), a prefix-cache hit
(its recurrent rows restored from the side slab on the rank that holds
the slot) and a temperature row.  Jamba at ``_torch_small.RECURRENT``'s
widths (d_in 256: ``conv`` and ``h`` split at 'model' 2 and 4) and 5 of
its superblock's 8 slots (Mamba at 0-3, MoE MLPs at 1 and 3, attention
at 4), xLSTM 256 wide (mLSTM's dv 128 splits at 'model' 2, its 4 heads
at 2 and 4) with its whole superblock (7 mLSTM, 1 sLSTM); the port's own
seeded weights, packed for v1-v3 by the port's converter.  The reference
engine cannot serve on a mesh (ROADMAP R1);
``test_torch_recurrent.py`` holds the 1x1 engine to the reference's
model-API loop.  The launcher's ``--mesh 2,2`` runs in a subprocess for
Jamba.
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
from _torch_small import RECURRENT
from repro_torch.configs import ARCHS, scale_down
from repro_torch.core.integrate import convert_params_to_sme, to_torch
from repro_torch.launch.mesh import Mesh
from repro_torch.models.model import build_model, init_params
from repro_torch.parallel.sharding import cache_sharding, shard_shape

ROOT = pathlib.Path(__file__).resolve().parents[1]
WIDTHS = {"jamba": ("jamba-v0.1-52b", dict(RECURRENT["jamba-v0.1-52b"],
                                           n_layers=5)),
          "xlstm": ("xlstm-1.3b", dict(RECURRENT["xlstm-1.3b"],
                                       d_model=256))}
#: family -> backend -> the meshes it serves on
RUNS = {fam: {None: MESHES, "v2": MESHES, "v3": ((2, 2),)}
        for fam in WIDTHS}
#: the worlds, side by side: (family, its backends)
WORLDS = [(fam, group) for fam in WIDTHS for group in ((None, "v3"),
                                                       ("v2",))]
#: chunks of 16: the shared 16-token prefix is one chunk (its snapshot
#: the hit), and a prompt tail costs fewer decode passes than at 8
ENGINE = dict(chunk_len=16)
CASES = [(fam, b, shape) for fam, runs in RUNS.items()
         for b, shapes in runs.items() for shape in shapes]
KEYS = sorted({(fam, b) for fam, b, _ in CASES}, key=str)


def _models(fam):
    """(api, backend -> params): the port's seeded weights (the embedding
    scaled to 0.05, as ``_torch_small``'s), dense and packed."""
    arch, over = WIDTHS[fam]
    cfg = scale_down(ARCHS[arch], **over)
    tree = init_params(cfg, np.random.default_rng(3))
    tree["embed"]["w"] = tree["embed"]["w"] * np.float32(0.05)
    packed = convert_params_to_sme(tree, squeeze=1, backend="all",
                                   device="cpu")
    return build_model(cfg, device="cpu"), {None: to_torch(tree, "cpu"),
                                            "v2": packed, "v3": packed}


def _case_id(case):
    fam, b, shape = case
    return f"{fam}-{b or 'dense'}-{shape[0]}x{shape[1]}"


def _name(fam, group):
    """A world's name: its family and backends."""
    return "-".join([fam] + [b or "dense" for b in group])


def _key_id(key):
    return f"{key[0]}-{key[1] or 'dense'}"


@pytest.fixture(scope="module", name="world")
def _world(tmp_path_factory):
    """(the 1x1 results of this process, {world: every rank's results},
    {arch family: its api})."""
    tmp = tmp_path_factory.mktemp("mesh_recurrent")
    fams = {fam: _models(fam) for fam in WIDTHS}

    def local():
        ref = {"tokens": {}, "logits": {}}
        for fam, (fam_api, fam_params) in fams.items():
            for b, p in fam_params.items():
                ref["tokens"][(fam, b)] = serve(fam_api, p, b,
                                                engine=ENGINE)[0]
                ref["logits"][(fam, b)] = prefill_logits(fam_api, p)
        return ref
    jobs = {_name(fam, group): dict(
        kind="family", engine=ENGINE, families={fam: (
            fams[fam][0], {b: fams[fam][1][b] for b in group})},
        runs={fam: {b: RUNS[fam][b] for b in group}})
        for fam, group in WORLDS}
    ref, ranks = worlds(tmp, jobs, local)
    return ref, ranks, {fam: api for fam, (api, _) in fams.items()}


def _ranks(world, fam, backend):
    """Every rank's results of the world that served ``backend`` of
    ``fam``."""
    group = next(g for f, g in WORLDS if f == fam and backend in g)
    return world[1][_name(fam, group)]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_recurrent_mesh_tokens_bit_identical(world, case):
    """Chunked prefill, a prefix hit, a temperature row (and v3's spec
    decode) on a mesh == the 1x1 mesh, token for token, on every rank."""
    fam, backend, _ = case
    ref = world[0]
    for r, out in enumerate(_ranks(world, fam, backend)):
        got = out["tokens"][case]
        assert got == ref["tokens"][(fam, backend)], (r, got)
        eng = out["engine"][case]
        assert eng["prefix_hits"] >= 1, eng
        assert (eng["spec_rounds"] > 0) == (backend == "v3"), eng


@pytest.mark.parametrize("key", KEYS, ids=_key_id)
def test_recurrent_mesh_prefill_logits_bitwise(world, key):
    """A ragged prefill window's f32 logits on (2, 2) equal the 1x1
    logits bitwise on every rank."""
    for out in _ranks(world, *key):
        assert torch.equal(out["logits"][key], world[0]["logits"][key])


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_recurrent_states_shard_by_the_rule(world, case):
    """Every layer's cache leaf on every rank has the shard shape of
    ``cache_sharding(exact=True)`` (``sharding.state_spec`` for the
    recurrent states): on (2, 2) Mamba's ``conv`` [2, 3, 128] and ``h``
    [2, 128, 8] (2 of 4 slot rows, half of d_in), mLSTM's ``C`` [2, 4,
    128, 64] (half of dv) and ``n`` [2, 2, 128] (2 of 4 heads), ``m`` and
    sLSTM's states 2 rows whole; on (1, 4) ``conv``/``h`` a quarter of
    d_in."""
    fam, backend, shape = case
    ranks = _ranks(world, fam, backend)
    meta = world[2][fam].init_cache(4, 64, device="meta")
    for rank, out in enumerate(ranks):
        mesh = Mesh(*shape, rank=rank, device="cpu", groups={"world": None})
        specs = cache_sharding(mesh, meta, 4, exact=True)
        want = [{k: shard_shape(mesh, sp[k], t.shape) for k, t in lay.items()}
                for lay, sp in zip(meta, specs)]
        assert out["states"][case] == want, rank
    got = ranks[0]["states"][case]
    if fam == "jamba" and shape == (2, 2):
        assert got[0] == {"conv": (2, 3, 128), "h": (2, 128, 8)}, got[0]
    if fam == "jamba" and shape == (1, 4):
        assert got[0] == {"conv": (4, 3, 64), "h": (4, 64, 8)}, got[0]
    if fam == "xlstm" and shape == (2, 2):
        assert got[0] == {"C": (2, 4, 128, 64), "n": (2, 2, 128),
                          "m": (2, 4)}, got[0]
        assert got[7] == {k: (2, 256) for k in "cnhm"}, got[7]


def test_recurrent_drafts_leave_side_leaves_and_nothing_sums(world):
    """v3's drafts left every side leaf (the recurrent states, on every
    rank's shard) bitwise as it was; every rank sampled rank 0's ids
    itself, no float all_reduce or reduce_scatter ran while serving, and
    no rank imported jax or the reference package."""
    for name, ranks in world[1].items():
        for out in ranks:
            assert (out["drafts"] > 0) == ("v3" in name)
            assert out["draft_changed"] == []
            assert out["mismatches"] == 0
            assert out["summed"] == []
            assert out["jax"] == []


def _reqs(text):
    return re.findall(r"^req \d+: .*$", text, re.M)


def test_launcher_mesh_2x2_jamba(capsys):
    """``launch/serve.py --arch jamba-v0.1-52b --mesh 2,2 --device cpu``
    prints the 1x1 run's tokens."""
    from repro_torch.launch.serve import main
    argv = ["--arch", "jamba-v0.1-52b", "--small", "--device", "cpu",
            "--sme", "--backend", "v2", "--requests", "3", "--max-new", "4"]
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
