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
(``_torch_mesh_ranks.run_rank``: no jax, one thread each, a file store
under ``tmp_path``) that run the whole matrix on the meshes (2, 2), (4,
1) and (1, 4) and save their results: ``_torch_small``'s 128-wide qwen
dense and v1, v2, v3 (v3 with self-speculative decode), every run with
chunked prefill, a prefix hit and a temperature row; mixtral's small
model (dense and v2) and a reference-written ``.smez`` booted with
``from_artifact(mesh=)`` on (2, 2); deepseek (MLA, MoE with shared
experts, the dense ``first0``; dense and v2 on all three meshes, v3 with
self-speculative decode on (2, 2)) and llava (the vision frontend, dense
and v2 on (2, 2)) at widths where ``kv_up`` and ``patch_proj`` split
into whole column tiles; the families mesh serving still leaves out;
one ``decode_chunk`` per engine step; a spy on the summing collectives.
The launcher's ``--mesh 2,2`` runs in a subprocess for qwen, deepseek
and llava.
"""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_mesh_ranks import (FAMILY_RUNS, MESHES, prefill_logits,
                               run_rank, serve)
from _torch_small import family_models, small_models
from repro_torch.configs import ARCHS, scale_down
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.model import build_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
BACKENDS = [None, "v1", "v2", "v3"]
IDS = ["dense", "v1", "v2", "v3"]
MOE = dict(d_model=128, expert_dff=128, dtype="float32")
#: deepseek with a 128-wide ``kv_lora`` (so ``kv_up`` packs) and 4 x
#: (64 + 64) up-projected columns: ``kv_up`` is 4 column tiles, split at
#: ``model`` 2 and 4; 8 experts, expert-parallel at ``model`` 4
MLA = dict(d_model=128, d_ff=256, expert_dff=128, n_experts=8, kv_lora=128,
           rope_head_dim=32, nope_head_dim=64, v_head_dim=64,
           dtype="float32")
#: llava 256 wide: ``patch_proj`` 256x256 is 2 column tiles (at 128 wide
#: it is one, and would not split)
VISION = dict(d_model=256, d_ff=256, head_dim=32, n_heads=8, n_kv_heads=2,
              vocab=256, dtype="float32")
FAMILIES = {"mla": ("deepseek-v2-lite-16b", MLA),
            "vision": ("llava-next-34b", VISION)}
LEFT_OUT = {
    "xlstm-1.3b": dict(d_model=128, d_ff=0, vocab=256, dtype="float32"),
    "whisper-medium": dict(d_model=128, n_layers=2, dtype="float32"),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the 1x1 results of this process, every rank's results)."""
    from repro.compiler import compile_model as ref_compile
    tmp = tmp_path_factory.mktemp("mesh")
    m = small_models()
    params = {b: m.port_dense if b is None else m.port_packed
              for b in BACKENDS}
    mix = family_models("mixtral-8x7b", **MOE)
    moe = {None: mix.port_dense, "v2": mix.port_packed}
    art = str(tmp / "m.smez")
    ref_compile(m.dense, out=art, backend="v1",
                extra={"serve_backend": "v1"})
    left = {a: build_model(scale_down(ARCHS[a], **o), device="cpu")
            for a, o in LEFT_OUT.items()}
    fams = {}
    for fam, (arch, over) in FAMILIES.items():
        f = family_models(arch, **over)
        fams[fam] = (f.port_api, {b: f.port_dense if b is None
                                  else f.port_packed
                                  for b in FAMILY_RUNS[fam]})
    torch.save(dict(api=m.port_api, params=params,
                    moe=(mix.port_api, moe), artifact=art, left_out=left,
                    families=fams), tmp / "job.pt")
    ctx = torch.multiprocessing.start_processes(
        run_rank, args=(4, str(tmp / "store"), str(tmp)), nprocs=4,
        join=False, start_method="spawn")
    # the 1x1 runs here while the ranks run theirs
    ref = {"tokens": {}, "logits": {}}
    for b, p in params.items():
        ref["tokens"][b] = serve(m.port_api, p, b)[0]
        ref["logits"][b] = prefill_logits(m.port_api, p)
    for b, p in moe.items():
        ref["tokens"][("moe", b)] = serve(mix.port_api, p, b)[0]
    ref["tokens"]["artifact"] = serve(m.port_api, None, None,
                                      artifact=art)[0]
    for fam, (fam_api, fam_params) in fams.items():
        for b, p in fam_params.items():
            ref["tokens"][(fam, b)] = serve(fam_api, p, b)[0]
            ref["logits"][(fam, b)] = prefill_logits(fam_api, p)
    while not ctx.join():
        pass
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    return ref, ranks


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


@pytest.mark.parametrize("backend", [None, "v2"], ids=["dense", "v2"])
def test_moe_mesh_tokens_bit_identical(world, backend):
    """mixtral's small model on (2, 2): dense experts expert-parallel (8
    experts, 4 per rank), packed ones column-split where they divide; the
    routing and combine on every rank in the 1x1 order."""
    ref, ranks = world
    for out in ranks:
        assert out["tokens"][("moe", backend)] == ref["tokens"][("moe",
                                                                 backend)]
    split = ranks[0]["moe_split"][backend]
    if backend is None:
        assert any(n.endswith("mlp/wi") for n in split), split


def test_smez_sharded_load_identity(world):
    """from_artifact(mesh=) of a reference-written .smez slices each leaf
    out of the mapping into its shard and serves the meshless boot's
    tokens."""
    ref, ranks = world
    for out in ranks:
        assert out["tokens"][("artifact", (2, 2))] == ref["tokens"][
            "artifact"]
    assert "/embed/w" in ranks[0]["artifact_split"]
    assert any(n.endswith("mlp/wi/w") for n in ranks[0]["artifact_split"])


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


FAMILY_CASES = [(fam, b, shape) for fam, runs in FAMILY_RUNS.items()
                for b, shapes in runs.items() for shape in shapes]


def _case_id(case):
    fam, b, shape = case
    return f"{fam}-{b or 'dense'}-{shape[0]}x{shape[1]}"


@pytest.mark.parametrize("case", FAMILY_CASES, ids=_case_id)
def test_mesh_tokens_bit_identical_mla_and_vision(world, case):
    """deepseek (MLA's ``c``/``k_pe`` rows over 'data', ``kv_up`` gathered
    whole, shared experts, ``first0``) and llava (``patch_proj``
    column-split, zero patches alike on every rank) on a mesh == their
    1x1 mesh, token for token, on every rank: chunked prefill, a prefix
    hit and a temperature row (deepseek; llava admits each prompt whole,
    with no prefix cache), v3 with self-speculative decode."""
    fam, backend, shape = case
    ref, ranks = world
    for r, out in enumerate(ranks):
        got = out["tokens"][case]
        assert got == ref["tokens"][(fam, backend)], (r, got)
        eng = out["engine"][case]
        if fam == "mla":
            assert eng["prefix_hits"] >= 1, eng
        assert (eng["spec_rounds"] > 0) == (backend == "v3"), eng


@pytest.mark.parametrize("key", sorted(
    {(fam, b) for fam, b, _ in FAMILY_CASES}, key=str),
    ids=lambda k: f"{k[0]}-{k[1] or 'dense'}")
def test_mesh_prefill_logits_bitwise_mla_and_vision(world, key):
    """A ragged prefill window's f32 logits on (2, 2) (llava's behind
    seeded patches) equal the 1x1 logits bitwise on every rank."""
    ref, ranks = world
    for out in ranks:
        assert torch.equal(out["logits"][key], ref["logits"][key])


@pytest.mark.parametrize("key", sorted(
    {(fam, b) for fam, b, _ in FAMILY_CASES}, key=str),
    ids=lambda k: f"{k[0]}-{k[1] or 'dense'}")
def test_mla_and_vision_leaves_actually_shard(world, key):
    """On (2, 2) deepseek's ``kv_up`` (4 column tiles; dense, 512
    columns) and llava's ``patch_proj`` (2 tiles; dense, 256 columns)
    split over 'model', and MLA's ``c``/``k_pe`` hold 2 of the 4 slot
    rows; llava's K/V 2 rows and 1 of 2 KV heads."""
    fam, backend = key
    _, ranks = world
    split = ranks[0]["split"][key]
    cache = ranks[0]["cache"][key]
    if fam == "mla":
        assert any(n.endswith("mix/kv_up/w") for n in split), split
        assert "/first0/mix/kv_up/w" in split, split
        assert cache == [(2, 64, 128), (2, 64, 32)], cache
    else:
        assert "/patch_proj/w" in split, split
        assert cache == [(2, 64, 1, 32)] * 2, cache


@pytest.mark.parametrize("arch", sorted(LEFT_OUT))
def test_left_out_family_raises_on_a_mesh(world, arch):
    _, ranks = world
    msg = ranks[0]["raises"].get(arch, "")
    assert "2x2 mesh waits for a later slice" in msg, msg


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


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "llava-next-34b"])
def test_launcher_mesh_2x2_mla_and_vision(capsys, arch):
    """``launch/serve.py --arch deepseek-v2-lite-16b|llava-next-34b --mesh
    2,2 --device cpu`` prints the 1x1 run's tokens."""
    from repro_torch.launch.serve import main
    argv = ["--arch", arch, "--small", "--device", "cpu", "--sme",
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
