"""The ssm arch's model-parallel LoRA train step (xlstm-1.3b, reduced) on
the (2, 2) and (1, 3) meshes against JAX's unsharded step; the setting
and bars are ``tests/test_torch_sharded_train.py``'s.  The mLSTM and
sLSTM recurrences run with their sequence and gates whole on each rank
(``nn.ssm``'s constrains), the projections split over ``model``."""

import os
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from sharded_train_common import (MESHES, check_grads,  # noqa: E402
                                  check_step, run_pair)

ARCH = "xlstm-1.3b"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_pair(str(tmp_path_factory.mktemp("sharded_train_ssm")),
                    (ARCH,), sharded=False)


@pytest.mark.parametrize("mesh", [f"{d}x{m}" for d, m in MESHES])
def test_sharded_step_matches_jax_unsharded(runs, mesh):
    reports, refs = runs
    loss, lora, _ = refs[ARCH][""]
    for rep in reports[mesh]:
        check_step(rep[ARCH], loss, lora)


@pytest.mark.parametrize("mesh", [f"{d}x{m}" for d, m in MESHES])
def test_sharded_grads_match_jax_unsharded(runs, mesh):
    """The step's LoRA gradients before the clip, leaf by leaf."""
    reports, refs = runs
    _, _, grads = refs[ARCH][""]
    for rep in reports[mesh]:
        check_grads(rep[ARCH], grads)


def test_projections_are_split_over_model(runs):
    """On (2, 2) the mLSTM's ``up`` and the sLSTM's ``wx`` (``mlp`` over
    ``model``) are half their whole size on every rank."""
    reports, _ = runs
    for rep in reports["2x2"]:
        shapes = rep[ARCH]["param_shapes"]
        for key in ("units/mlstm/up/w", "units/slstm/wx/w"):
            loc, whole = shapes[key]
            assert np.prod(loc) * 2 == np.prod(whole), key
