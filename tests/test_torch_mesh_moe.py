"""Mesh serving of the MoE family and of a compiled artifact on
``torch.distributed`` ranks: bit-identity with the 1x1 mesh (the
contract of ``test_torch_mesh.py``).

One module fixture spawns four ``gloo`` ranks on the CPU
(``_torch_mesh_ranks.world``) that serve mixtral's small model (dense
and v2) and a reference-written ``.smez`` booted with
``from_artifact(mesh=)`` on (2, 2) while this process serves them on the
1x1 mesh.
"""
import pytest

from _torch_mesh_ranks import serve, world
from _torch_small import family_models, small_models

MOE = dict(d_model=128, expert_dff=128, dtype="float32")


@pytest.fixture(scope="module", name="world")
def _world(tmp_path_factory):
    """(the 1x1 results of this process, every rank's results)."""
    from repro.compiler import compile_model as ref_compile
    tmp = tmp_path_factory.mktemp("mesh_moe")
    m = small_models()
    mix = family_models("mixtral-8x7b", **MOE)
    moe = {None: mix.port_dense, "v2": mix.port_packed}
    art = str(tmp / "m.smez")
    ref_compile(m.dense, out=art, backend="v1",
                extra={"serve_backend": "v1"})

    def local():
        ref = {"tokens": {}}
        for b, p in moe.items():
            ref["tokens"][("moe", b)] = serve(mix.port_api, p, b)[0]
        ref["tokens"]["artifact"] = serve(m.port_api, None, None,
                                          artifact=art)[0]
        return ref
    return world(tmp, dict(kind="moe", api=m.port_api,
                           moe=(mix.port_api, moe), artifact=art), local)


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


def test_every_rank_agrees_and_nothing_sums(world):
    """Every rank sampled rank 0's ids itself (none differed before the
    broadcast), no float all_reduce or reduce_scatter ran while serving,
    and no rank imported jax or the reference package."""
    _, ranks = world
    for out in ranks:
        assert out["mismatches"] == 0
        assert out["summed"] == []
        assert out["jax"] == []
