"""Mesh serving of MLA (deepseek-v2-lite) and the vision frontend
(llava-next-34b) on ``torch.distributed`` ranks: bit-identity with the
1x1 mesh (the contract of ``test_torch_mesh.py``).

One module fixture spawns four ``gloo`` ranks on the CPU
(``_torch_mesh_ranks.world``) that run :data:`FAMILY_RUNS`: deepseek
(MLA, MoE with shared experts, the dense ``first0``; dense and v2 on
(2, 2), (4, 1) and (1, 4), v3 with self-speculative decode on (2, 2))
and llava (dense and v2 on (2, 2)) at widths where ``kv_up`` and
``patch_proj`` split into whole column tiles, while this process serves
them on the 1x1 mesh.  The launcher's ``--mesh 2,2`` runs in a
subprocess for both.
"""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from _torch_mesh_ranks import FAMILY_RUNS, prefill_logits, serve, world
from _torch_small import family_models

ROOT = pathlib.Path(__file__).resolve().parents[1]
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


@pytest.fixture(scope="module", name="world")
def _world(tmp_path_factory):
    """(the 1x1 results of this process, every rank's results)."""
    tmp = tmp_path_factory.mktemp("mesh_mla_vision")
    fams = {}
    for fam, (arch, over) in FAMILIES.items():
        f = family_models(arch, **over)
        fams[fam] = (f.port_api, {b: f.port_dense if b is None
                                  else f.port_packed
                                  for b in FAMILY_RUNS[fam]})

    def local():
        ref = {"tokens": {}, "logits": {}}
        for fam, (fam_api, fam_params) in fams.items():
            for b, p in fam_params.items():
                ref["tokens"][(fam, b)] = serve(fam_api, p, b)[0]
                ref["logits"][(fam, b)] = prefill_logits(fam_api, p)
        return ref
    return world(tmp, dict(kind="family", families=fams, runs=FAMILY_RUNS),
                 local)


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


def test_every_rank_agrees_and_nothing_sums(world):
    """Every rank sampled rank 0's ids itself (none differed before the
    broadcast), no float all_reduce or reduce_scatter ran while serving,
    and no rank imported jax or the reference package."""
    _, ranks = world
    for out in ranks:
        assert out["mismatches"] == 0
        assert out["summed"] == []
        assert out["jax"] == []



def _reqs(text):
    return re.findall(r"^req \d+: .*$", text, re.M)


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
