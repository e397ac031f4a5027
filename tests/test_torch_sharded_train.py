"""Model-parallel LoRA train steps of the port on a ``(data, model)`` mesh,
against the JAX package.

One AdamW step (clip 1.0, lr 1e-3) of a reduced arch's LoRA, with every
parameter, LoRA leaf, optimizer-state leaf and the batch placed by the
port's ``logical_to_sharding`` / ``batch_shardings`` /
``opt_state_shardings`` as DTensors, on 4 gloo CPU ranks on the (2, 2)
mesh and on 3 on the (1, 3) mesh (``tests/torch_model_ranks.py``).  The
attention runs query chunks of 6 rows (the training rule "auto" past one
chunk), so on (1, 3), whose ``model`` axis the 4 heads do not divide,
attention shards each chunk's rows over ``model``; the LoRA ``b``
factors start from 0.05 N(0, 1) so that every LoRA leaf moves.

* here the dense and hybrid archs (qwen2-0.5b, hymba-1.5b), and in
  ``test_torch_sharded_train_ssm.py`` the ssm arch (xlstm-1.3b):
  against JAX's unsharded step;
* in ``test_torch_sharded_train_moe.py`` the MoE archs
  (granite-moe-3b-a800m, deepseek-v2-236b): against JAX's ``jax.jit``
  step with ``in_shardings`` on the same mesh of host devices (its
  capacity and aux are per shard): expert-parallel on (2, 2),
  token-parallel on (1, 3).

The parameters come from the port's own init (numpy to both sides).
Bars (fp32): loss within rtol 1e-5, updated LoRA within rel L2 1e-4,
and each LoRA leaf's gradient before the clip within rel L2 1e-4 (the
first AdamW step keeps about each element's sign, so the gradients are
what hold the size of the sharded backward).
All the JAX references come from one subprocess a file
(``tests/sharded_train_common.py``).  The first sharded step of a rank
spends most of its time in DTensor's sharding planning, which it
caches, so each file keeps to one or two archs.
"""

import os
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from sharded_train_common import (MESHES, check_grads,  # noqa: E402
                                  check_step, run_pair)

ARCHS = ("qwen2-0.5b", "hymba-1.5b")


@pytest.fixture(scope="module")
def dense_runs(tmp_path_factory):
    return run_pair(str(tmp_path_factory.mktemp("sharded_train")), ARCHS,
                    sharded=False)


@pytest.mark.parametrize("mesh", [f"{d}x{m}" for d, m in MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_jax_unsharded(dense_runs, arch, mesh):
    reports, refs = dense_runs
    loss, lora, _ = refs[arch][""]
    for rep in reports[mesh]:
        check_step(rep[arch], loss, lora)


@pytest.mark.parametrize("mesh", [f"{d}x{m}" for d, m in MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_grads_match_jax_unsharded(dense_runs, arch, mesh):
    """The step's LoRA gradients before the clip, leaf by leaf."""
    reports, refs = dense_runs
    _, _, grads = refs[arch][""]
    for rep in reports[mesh]:
        check_grads(rep[arch], grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_parameters_are_split_over_model(dense_runs, arch):
    """On (2, 2) the ranks hold blocks, not copies: the FFN's weights
    (``mlp`` over ``model``) are half their whole size on every rank."""
    reports, _ = dense_runs
    for rep in reports["2x2"]:
        split = [k for k, (loc, whole) in rep[arch]["param_shapes"].items()
                 if np.prod(loc) * 2 == np.prod(whole)]
        assert any("ffn" in k or "up" in k for k in split), split
