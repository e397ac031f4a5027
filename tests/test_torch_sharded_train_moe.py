"""The MoE archs' model-parallel LoRA train steps (granite-moe-3b-a800m
and deepseek-v2-236b, reduced: 4 experts, top-2) against JAX's ``jax.jit``
step with ``in_shardings`` on the same mesh of host devices: on (2, 2)
the experts split over ``model`` (expert-parallel, their embed dim over
``data`` at rest), on (1, 3), which 4 experts do not divide, the
token-parallel form.  The setting and bars are
``tests/test_torch_sharded_train.py``'s.  The reduced granite's (2, 2)
step has its collectives pinned by kind: DTensor's, counted by
``CommDebugMode``, and the MoE's counted psums (two a layer: the
expert-parallel combine over ``model`` and the aux's mean)."""

import os
import sys

import pytest

pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from sharded_train_common import (MESHES, check_grads,  # noqa: E402
                                  check_step, run_pair)

ARCHS = ("granite-moe-3b-a800m", "deepseek-v2-236b")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_pair(str(tmp_path_factory.mktemp("sharded_train_moe")),
                    ARCHS, sharded=True)


@pytest.mark.parametrize("mesh", [f"{d}x{m}" for d, m in MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_jax_sharded(runs, arch, mesh):
    reports, refs = runs
    loss, lora, _ = refs[arch][mesh]
    for rep in reports[mesh]:
        check_step(rep[arch], loss, lora)


@pytest.mark.parametrize("mesh", [f"{d}x{m}" for d, m in MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_grads_match_jax_sharded(runs, arch, mesh):
    """The step's LoRA gradients before the clip, leaf by leaf: the
    sizes the expert-parallel combine, the token-parallel form and the
    aux's mean give the backward."""
    reports, refs = runs
    _, _, grads = refs[arch][mesh]
    for rep in reports[mesh]:
        check_grads(rep[arch], grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_experts_split_over_both_axes_at_rest(runs, arch):
    """Expert-parallel on (2, 2): each rank holds 2 of the 4 experts and
    half of each one's embed dim (``expert_embed`` over ``data``)."""
    reports, _ = runs
    for rep in reports["2x2"]:
        loc, whole = rep[arch]["param_shapes"]["units/blk/ffn/experts/gate"]
        assert loc[1] * 2 == whole[1] and loc[2] * 2 == whole[2], (loc,
                                                                    whole)


# DTensor's moves of one step (forward, backward, the clip's global norm,
# AdamW) by kind as DTensor plans them in this torch, and the counted
# psums (``allreduce_`` in CommDebugMode's count): 2 layers x 2
GRANITE_2X2_COMMS = ({"all_gather_into_tensor": 21, "all_reduce": 14,
                      "reduce_scatter_tensor": 8, "allreduce_": 4}, 4)


def test_granite_collective_budget(runs):
    """The reduced granite's (2, 2) step, every rank: the collectives by
    kind, pinned."""
    reports, _ = runs
    got = [(rep["granite-moe-3b-a800m"]["comms"],
            rep["granite-moe-3b-a800m"]["psums"]) for rep in reports["2x2"]]
    assert all(g == got[0] for g in got)
    assert got[0] == GRANITE_2X2_COMMS
