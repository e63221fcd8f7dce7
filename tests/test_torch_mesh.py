"""Mesh serving on ``torch.distributed`` ranks: bit-identity with the 1x1
mesh (DESIGN.md §7; the port's counterpart of ``tests/test_serve_mesh.py``).

The contract: on any ``(data, model)`` mesh the engine's greedy and
sampled tokens equal the 1x1 mesh's, token for token, and its f32 logits
bitwise, because under the exact posture only output-feature, head,
expert and slot dims split and every collective is a gather or a select.
The reference engine cannot serve on a mesh under this jax (ROADMAP R1),
so the mesh is held against the port's own 1x1 engine, which the other
``test_torch_*`` files hold to the reference's model API.

One module fixture spawns four ``gloo`` ranks on the CPU
(``_torch_mesh_ranks.world``: no jax, one thread each, a file store under
``tmp_path``) that run ``_torch_small``'s 128-wide qwen dense and v1, v2,
v3 (v3 with self-speculative decode) on the meshes (2, 2), (4, 1) and
(1, 4), every run with chunked prefill, a prefix hit and a temperature
row, and save their results; one ``decode_chunk`` per engine step; a spy
on the summing collectives.  The launcher's ``--mesh 2,2`` runs in a
subprocess.  The other families' mesh runs have files and worlds of
their own (``test_torch_mesh_moe.py``, ``test_torch_mesh_mla_vision.py``,
``test_torch_mesh_recurrent.py``, ``test_torch_mesh_encdec.py``), so
that ``--dist loadfile`` runs them side by side.
"""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from _torch_mesh_ranks import MESHES, prefill_logits, serve, world
from _torch_small import small_models
from repro_torch.launch.mesh import make_local_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
BACKENDS = [None, "v1", "v2", "v3"]
IDS = ["dense", "v1", "v2", "v3"]


@pytest.fixture(scope="module", name="world")
def _world(tmp_path_factory):
    """(the 1x1 results of this process, every rank's results)."""
    tmp = tmp_path_factory.mktemp("mesh")
    m = small_models()
    params = {b: m.port_dense if b is None else m.port_packed
              for b in BACKENDS}

    def local():
        ref = {"tokens": {}, "logits": {}}
        for b, p in params.items():
            ref["tokens"][b] = serve(m.port_api, p, b)[0]
            ref["logits"][b] = prefill_logits(m.port_api, p)
        return ref
    return world(tmp, dict(kind="dense", api=m.port_api, params=params),
                 local)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("backend", BACKENDS, ids=IDS)
def test_mesh_tokens_bit_identical(world, backend, shape):
    """Ragged batch, chunked prefill, a prefix hit, a temperature row (and
    v3's spec decode) on a mesh == the 1x1 mesh, token for token, on every
    rank."""
    ref, ranks = world
    for r, out in enumerate(ranks):
        got = out["tokens"][(backend, shape)]
        assert got == ref["tokens"][backend], (r, got)


@pytest.mark.parametrize("backend", BACKENDS, ids=IDS)
def test_mesh_prefill_logits_bitwise(world, backend):
    """A ragged prefill window's f32 logits on (2, 2), gathered over the
    vocab-split tied head, equal the 1x1 logits bitwise on every rank."""
    ref, ranks = world
    for out in ranks:
        assert torch.equal(out["logits"][backend], ref["logits"][backend])


@pytest.mark.parametrize("backend", BACKENDS, ids=IDS)
def test_param_leaves_actually_shard(world, backend):
    """On (2, 2) the embedding's vocab rows split, and so does every weight
    whose output dim does (the packed ones by whole column tiles: wi/wg,
    two tiles); a rank holds less than the whole tree; the caches hold
    their rank's 2 of 4 slot rows and 2 of 4 KV heads."""
    ref, ranks = world
    split = ranks[0]["split"][backend]
    assert "/embed/w" in split
    assert any(n.endswith("mlp/wi/w") for n in split), split
    assert any(n.endswith("mix/q/w") for n in split) == (backend is None)
    m = small_models()
    tree = m.port_dense if backend is None else m.port_packed

    def nbytes(t):
        if isinstance(t, dict):
            return sum(nbytes(v) for v in t.values())
        if isinstance(t, (list, tuple)):
            return sum(nbytes(v) for v in t)
        return t.numel() * t.element_size()
    assert ranks[0]["bytes"][backend] < nbytes(tree)
    assert ranks[0]["cache"][backend] == [(2, 64, 2, 32)] * 2


def test_one_decode_per_step_under_sharding(world):
    _, ranks = world
    for out in ranks:
        calls, decode_steps, steps = out["chunk_calls"]
        assert calls == decode_steps == steps


def test_every_rank_agrees_and_nothing_sums(world):
    """Every rank sampled rank 0's ids itself (none differed before the
    broadcast), no float all_reduce or reduce_scatter ran while serving,
    and no rank imported jax or the reference package."""
    _, ranks = world
    for out in ranks:
        assert out["mismatches"] == 0
        assert out["summed"] == []
        assert out["jax"] == []


def test_default_engine_is_1x1_mesh():
    """No mesh is the 1x1 mesh, through the same code: the same tokens as
    an explicit ungrouped 1x1 mesh, every leaf whole and untouched."""
    m = small_models()
    toks, eng = serve(m.port_api, m.port_packed, "v2")
    assert eng.mesh.size == 1 and eng.mesh.groups == {}
    assert eng.params is m.port_packed
    got, _ = serve(m.port_api, m.port_packed, "v2",
                   mesh=make_local_mesh(1, 1, device="cpu"))
    assert got == toks


def test_mesh_refusals():
    """NCCL with more ranks than cards, NCCL on the CPU, and a mesh needing
    ranks that do not run all raise with a message."""
    from repro_torch.launch.serve import _parser, dist_backend
    args = _parser().parse_args(["--mesh", "2,2"])
    with pytest.raises(SystemExit, match="NCCL refuses two ranks on one"):
        dist_backend(args, 4)
    args = _parser().parse_args(["--device", "cpu", "--dist-backend",
                                 "nccl"])
    with pytest.raises(SystemExit, match="needs --device cuda"):
        dist_backend(args, 1)
    assert dist_backend(_parser().parse_args(["--device", "cpu"]), 4) == \
        "gloo"
    with pytest.raises(ValueError, match="initialise torch.distributed"):
        make_local_mesh(2, 2, device="cpu")


def _reqs(text):
    return re.findall(r"^req \d+: .*$", text, re.M)


def test_launcher_mesh_2x2_matches_1x1(capsys):
    """``launch/serve.py --mesh 2,2 --device cpu`` spawns four gloo ranks
    and prints the 1x1 run's tokens; only rank 0 prints."""
    from repro_torch.launch.serve import main
    argv = ["--small", "--device", "cpu", "--sme", "--backend", "v3",
            "--requests", "3", "--max-new", "4"]
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
    assert proc.stdout.count("stats:") == 1
