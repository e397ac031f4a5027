"""``nn.attention.sharded_sdpa``, the attention core on each rank's
blocks under a mesh, against the plain core on whole tensors, on 4 gloo
CPU ranks (``tests/torch_model_ranks.py WORK attn``), forward and the
gradients of q, k and v, in fp32 to rtol 1e-5 of each tensor's scale.
The cases reach every split it makes on ``model``: the heads with the
KV heads; the heads alone (each rank taking the KV heads its query
heads read); the query rows with their mask rows; none; and a batch
that ``data`` does not divide.  The ranks route DTensor's all-gathers
through ``launch.mesh.route_all_gather``, as gloo ranks on a card do,
so the whole tensors gathered here test that routing too."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
RTOL = 1e-5

# name: (mesh, B, Q, S, heads, kv heads, head dim, causal mask, split)
CASES = {
    "heads_kv": ((2, 2), 4, 6, 6, 4, 2, 8, True, "S(2)"),
    "heads_only": ((1, 4), 2, 6, 6, 4, 2, 8, True, "S(2)"),
    "rows": ((2, 2), 4, 8, 8, 3, 1, 8, True, "S(1)"),
    "rows_cross": ((1, 4), 2, 8, 5, 3, 3, 4, False, "S(1)"),
    "whole": ((2, 2), 4, 7, 7, 3, 3, 8, True, "R"),
    "batch_unsplit": ((2, 2), 3, 6, 6, 4, 4, 8, True, "S(2)"),
}


def make_cases():
    out = {}
    for i, (name, (mesh, b, q, s, h, kv, hd, causal, _)) in enumerate(
            sorted(CASES.items())):
        rng = np.random.default_rng(200 + i)
        f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa
        mask = (np.tril(np.ones((q, s), bool), s - q) if causal else None)
        out[name] = dict(mesh=mesh, h=h, kv=kv, hd=hd, q=f(b, q, h, hd),
                         k=f(b, s, kv, hd), v=f(b, s, kv, hd),
                         w=f(b, q, h, hd), mask=mask)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("sharded_attn"))
    with open(os.path.join(work, "attn.pkl"), "wb") as f:
        pickle.dump(make_cases(), f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = {m: subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_model_ranks.py"), work,
         "attn", m], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for m in ("2x2", "1x4")}
    reps = {}
    for m, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        reps[m] = []
        for r in range(4):
            with open(os.path.join(work, f"attn_{m}_{r}.pkl"), "rb") as f:
                reps[m].append(pickle.load(f))
    return reps


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_sdpa_matches_plain(runs, name):
    mesh = CASES[name][0]
    split = CASES[name][-1]
    for rep in runs[f"{mesh[0]}x{mesh[1]}"]:
        got = rep[name]
        for what, err, scale in zip(("out", "dq", "dk", "dv"), got["err"],
                                    got["scale"]):
            assert err <= RTOL * scale, (what, err, scale)
        data = "S(0)" if mesh[0] > 1 and CASES[name][1] % mesh[0] == 0 \
            else "R"
        assert got["placements"] == [data, split], got["placements"]
