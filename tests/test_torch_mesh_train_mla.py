"""Mesh training of MLA (deepseek-v2-lite's family) under the throughput
posture on ``torch.distributed`` ranks, held to the reference's
single-device step (``_torch_mesh_train_cases``).

deepseek's small config (its dense ``first0``, then MLA and an MoE layer
of 4 routed experts top-2 plus 2 shared, untied head; 128 wide, experts
of 128, f32) trains for 2 AdamW steps on (2, 2), (4, 1) and (1, 4) at 1
and 2 microbatches: MLA's q, kv_down and kv_up column-parallel and o
row-parallel, the shared experts and ``first0``'s MLP column/row, the
routed experts expert-parallel.  One module fixture spawns four ``gloo``
ranks on the CPU (the ``"train_moe"`` job of ``_torch_mesh_ranks``)
while this process runs the reference's and the port's single-device
steps and the port's step on the 1x1 mesh, which must be ``mesh=None``'s
bitwise.
"""
import pytest

import _torch_mesh_train_cases as cases

NAMES = ("deepseek",)
RUNS = cases.runs(NAMES)


@pytest.fixture(scope="module", name="world")
def _world(tmp_path_factory):
    return cases.train_world(
        tmp_path_factory.mktemp("mesh_train_mla"), NAMES)


@pytest.mark.parametrize("run", RUNS, ids=cases.ids)
def test_mesh_step_matches_reference_single_device(world, run):
    """Every rank's losses within 1e-5 of the reference's single-device
    step at the same microbatches, its gathered params, m and v within
    1e-5 of each tree's largest magnitude."""
    cases.check_reference(world, run)


@pytest.mark.parametrize("run", RUNS, ids=cases.ids)
def test_mesh_step_matches_port_one_by_one(world, run):
    """The same against the port's own single-device step, and each
    step's pre-clip norm within 1e-6."""
    cases.check_one_by_one(world, run)


def test_loss_bitwise_on_every_rank(world):
    """The loss and the norm the same bits on every rank; no rank imported
    jax or the reference package."""
    cases.check_loss_bitwise(world, NAMES)


def test_one_by_one_mesh_step_is_mesh_none_bitwise(world):
    """The step on the 1x1 mesh is ``mesh=None``'s bitwise (losses, norms,
    routes, params, m, v)."""
    cases.check_mesh_none(world, "deepseek")


def test_route_flips_counted(world):
    """Rank 0's routes against the 1x1 step's, counted and printed
    (``-s``)."""
    cases.route_flips(world, NAMES)


def test_each_rank_holds_a_quarter(world):
    """params + m + v per rank 0.25-0.27 of the 1x1 bytes."""
    cases.check_quarter(world, NAMES)


def test_expert_stacks_cut_as_the_rule_says(world):
    """Expert-parallel stacks where the experts divide 'model', expert-TP
    on F where they do not."""
    cases.check_expert_cuts(world, NAMES)
