"""The port's taskvec-sharded round on 8 gloo CPU ranks, against its own
unsharded round and against the JAX package's rounds.

The ranks run once for the whole file (``tests/torch_sharded_ranks.py``,
spawned in a subprocess by a module-scoped fixture); each rank writes a
report of its checks, rank 0 also the sharded rounds' whole outputs.  The
uploads are made here, with numpy from a seed through the JAX package's
``unify_with_modulators`` and bf16 transport, as the JAX package's own
sharded tests make them.

Parity bar:

* sharded ≡ unsharded **bit for bit** in the port, both layouts, on the
  (4, 2) debug mesh, the (2, 4) population mesh and the 8-rank round
  mesh, on ragged rounds and d not divisible by shards·32 — every output
  and every downlink; ``round_chunked`` at chunks 1, 3 (a non-divisor)
  and 8 (more than N) on the debug and population meshes bitwise the
  monolithic unsharded round;
* against the JAX package's unsharded round (and its sharded round on
  its own (4, 2) host-device mesh): the engine bar of
  ``tests/test_torch_engine.py`` — alpha_num, n_held and m̂ bitwise;
  τ̂, task vectors, S and λ to rtol 1e-5, atol 1e-6; downlink mask bits
  ≥ 99.999 % equal, bf16 downlink vectors within one ulp;
* collectives: ``run_packed`` calls ``psum`` twice (the dots as an int32
  (T, T) tensor, then the λ roots) and no other collective;
  ``round_chunked`` 2 + 1 per chunk; client unify 1;
* strategy and simulators: task vectors within rtol 1e-4, atol 1e-5 of
  the unsharded run (JAX's bar for client unify; the port's are also
  checked bitwise), masks and wire bits equal.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core.client import ClientUpload as JUpload  # noqa: E402
from repro.core.unify import unify_with_modulators  # noqa: E402
from repro.fed.compression import quantize_bf16_transport  # noqa: E402
from repro_torch.kernels import bitpack  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import torch_sharded_ranks as ranks  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
MESHES = ("debug4x2", "pop_s2", "round8")
LAYOUTS = ("packed", "bool")


def make_uploads(seed, n, n_tasks, d, k_max):
    """The JAX package's sharded-test uploads, as numpy rows."""
    rng = np.random.default_rng(seed)
    rows = []
    for cid in range(n):
        k = int(rng.integers(1, k_max + 1))
        tasks = sorted(rng.choice(n_tasks, size=k, replace=False).tolist())
        tvs = jnp.asarray(rng.standard_normal((k, d)), jnp.float32)
        uni, masks, lams = unify_with_modulators(tvs)
        rows.append(dict(
            cid=cid, tasks=tasks,
            unified=np.asarray(quantize_bf16_transport(uni), np.float32),
            masks=np.array(masks, bool), lams=np.array(lams, np.float32),
            sizes=rng.integers(10, 200, size=k).tolist()))
    return rows


def jax_uploads(rows):
    return [JUpload(r["cid"], r["tasks"], jnp.asarray(r["unified"]),
                    jnp.asarray(r["masks"]), jnp.asarray(r["lams"]),
                    r["sizes"]) for r in rows]


_JAX_SHARDED = textwrap.dedent("""
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["REPRO_DISABLE_PALLAS"] = "1"
    import numpy as np, jax, jax.numpy as jnp
    from repro.core.client import ClientUpload
    from repro.core.engine import EngineConfig, RoundEngine
    from repro.launch.mesh import make_debug_mesh
    work = sys.argv[1]
    with open(os.path.join(work, "uploads.pkl"), "rb") as f:
        rows = pickle.load(f)["cases"][0]
    ups = [ClientUpload(r["cid"], r["tasks"], jnp.asarray(r["unified"]),
                        jnp.asarray(r["masks"]), jnp.asarray(r["lams"]),
                        r["sizes"]) for r in rows]
    eng = RoundEngine(EngineConfig(n_tasks=6), mesh=make_debug_mesh((4, 2)))
    res = {"devices": len(jax.devices())}
    for packed in (True, False):
        _, out = eng.round(ups, packed=packed)
        res["packed" if packed else "bool"] = {
            f: np.asarray(getattr(out, f)) for f in (
                "task_vectors", "tau_hats", "similarity", "m_hats",
                "down_unified", "down_masks", "down_lams")}
    with open(os.path.join(work, "jax_sharded.pkl"), "wb") as f:
        pickle.dump(res, f)
""")


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    """Run the 8 ranks once (and JAX's sharded round once); returns
    (per-rank reports, the uploads, JAX's sharded outputs)."""
    work = str(tmp_path_factory.mktemp("sharded"))
    data = {"cases": [make_uploads(seed, n, t, d, km) for seed, (n, t, d, km)
                      in enumerate(ranks.CASES)]}
    with open(os.path.join(work, "uploads.pkl"), "wb") as f:
        pickle.dump(data, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    jax_proc = subprocess.Popen([sys.executable, "-c", _JAX_SHARDED, work],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    out = subprocess.run([sys.executable, os.path.join(HERE,
                                                       "torch_sharded_ranks.py"),
                          work], env=env, capture_output=True, text=True,
                         timeout=600)
    _, jax_err = jax_proc.communicate(timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert jax_proc.returncode == 0, jax_err[-4000:]
    reps = []
    for r in range(ranks.WORLD):
        with open(os.path.join(work, f"report_{r}.pkl"), "rb") as f:
            reps.append(pickle.load(f))
    with open(os.path.join(work, "jax_sharded.pkl"), "rb") as f:
        jax_sharded = pickle.load(f)
    return reps, data, jax_sharded


def all_ranks(reps, key):
    return [rep["checks"][key] for rep in reps]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", range(len(ranks.CASES)))
def test_sharded_round_bitwise_unsharded(report, mesh, layout, case):
    """Every rank's whole outputs and downlinks equal the unsharded
    round's bit for bit."""
    reps, _, _ = report
    assert all(all_ranks(reps, f"round/{mesh}/{case}/{layout}"))


def assert_close_to_jax(to, jo, n, valid, d, packed):
    """The port's whole round outputs (numpy) against a JAX round's, at
    the engine bar; JAX's client axis may be padded past n."""
    np.testing.assert_array_equal(
        to["m_hats_dense"] if not packed else
        np.where((m := to["alpha_num"].astype(np.float32)
                  / np.maximum(to["n_held"], 1.0)[:, None]) >= 0.4, 1.0, m),
        np.asarray(jo["m_hats"]))
    for name in ("tau_hats", "task_vectors", "similarity"):
        np.testing.assert_allclose(to[name], np.asarray(jo[name]), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    np.testing.assert_allclose(to["down_lams"],
                               np.asarray(jo["down_lams"])[:n], rtol=RTOL,
                               atol=ATOL)
    if packed:
        tb = bitpack.unpack_bits_np(
            to["down_masks"].view(np.uint32), d)
        jb = bitpack.unpack_bits_np(np.asarray(jo["down_masks"])[:n], d)
        tu = torch.from_numpy(to["down_unified"]).to(torch.bfloat16)
        ju = np.asarray(jo["down_unified"])[:n].view(np.int16)
        ulp = np.abs(tu.view(torch.int16).numpy().astype(np.int32)
                     - ju.astype(np.int32))
        assert ulp.max() <= 1
    else:
        tb = to["down_masks"]
        jb = np.asarray(jo["down_masks"])[:n]
        np.testing.assert_allclose(to["down_unified"],
                                   np.asarray(jo["down_unified"])[:n],
                                   rtol=RTOL, atol=ATOL)
    assert (tb == jb)[valid].mean() >= 0.99999


def _valid(rows, k_max):
    ks = [len(r["tasks"]) for r in rows]
    return np.arange(k_max)[None, :] < np.asarray(ks)[:, None]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", range(len(ranks.CASES)))
def test_sharded_round_within_jax_bar(report, layout, case):
    """The port's sharded round (debug mesh) against the JAX package's
    unsharded round on the same uploads."""
    reps, data, _ = report
    n, t, d, _ = ranks.CASES[case]
    rows = data["cases"][case]
    packed = layout == "packed"
    _, jo = jeng.RoundEngine(jeng.EngineConfig(n_tasks=t)).round(
        jax_uploads(rows), mode="ref", packed=packed)
    to = reps[0]["outputs"][f"{case}/{layout}"]
    if packed:
        np.testing.assert_array_equal(to["alpha_num"],
                                      np.asarray(jo.alpha_num))
        np.testing.assert_array_equal(to["n_held"], np.asarray(jo.n_held))
    jo = {f: getattr(jo, f) for f in ("task_vectors", "tau_hats",
                                      "similarity", "m_hats", "down_unified",
                                      "down_masks", "down_lams")}
    k_max = to["down_lams"].shape[1]
    assert_close_to_jax(to, jo, n, _valid(rows, k_max), d, packed)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_round_within_jax_sharded_bar(report, layout):
    """The port's (4, 2) sharded round against the JAX package's own
    sharded round on its 8-host-device (4, 2) mesh."""
    reps, data, jax_sharded = report
    assert jax_sharded["devices"] == 8
    n, _, d, _ = ranks.CASES[0]
    to = reps[0]["outputs"][f"0/{layout}"]
    k_max = to["down_lams"].shape[1]
    assert_close_to_jax(to, jax_sharded[layout], n,
                        _valid(data["cases"][0], k_max), d,
                        layout == "packed")


@pytest.mark.parametrize("chunk", ranks.CHUNKS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mesh", ("debug4x2", "pop_s2"))
def test_chunked_sharded_bitwise_monolithic(report, mesh, layout, chunk):
    """round_chunked on a mesh (the sink sees every row on every rank)
    ≡ the unsharded monolithic round, outputs, downlinks and bits."""
    reps, _, _ = report
    assert all(all_ranks(reps, f"chunked/{mesh}/{layout}/{chunk}"))


def test_chunked_sharded_coded_downlinks(report):
    reps, _, _ = report
    assert all(all_ranks(reps, "chunked/pop_s2/coded"))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_run_packed_collective_budget(report, layout):
    """Exactly two psums inside run_packed — the (T, T) dots as int32,
    then every λ root in one fp32 column tensor — and no other
    collective; the output is this rank's slice of the padded d."""
    reps, _, _ = report
    n, t, d, _ = ranks.CASES[0]
    for rep in reps:
        c = rep["counts"][f"run_packed/{layout}"]
        assert c["calls"] == {"all_reduce": 2}, c
        assert c["psum"] == {"psum": 2, "gather": 0}, c
        assert c["reduced"][0] == ("torch.int32", (t, t)), c
        dtype, shape = c["reduced"][1]
        assert dtype == "torch.float32" and shape[1] == 8, c
        assert c["d_pad"] == c["want_d_pad"] == 2048
        assert c["width"] == 2048 // 8


@pytest.mark.parametrize("chunk", ranks.CHUNKS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mesh", ("debug4x2", "pop_s2"))
def test_chunked_collective_budget(report, mesh, layout, chunk):
    """round_chunked: the dots and λ-numerator psums in the finish plus
    one λ-denominator psum a phase-C chunk; every all-reduce is a psum."""
    reps, _, _ = report
    for rep in reps:
        c = rep["counts"][f"chunked/{mesh}/{layout}/{chunk}"]
        assert c["n_chunks"] == -(-ranks.CASES[0][0] // chunk)
        assert c["psum"] == 2 + c["n_chunks"] == c["all_reduce"], c


@pytest.mark.parametrize("layout", LAYOUTS)
def test_client_unify_one_psum(report, layout):
    """Sharded client unify: one psum; unified vectors and masks (whole)
    and λ bitwise the unsharded call, hence also within JAX's rtol 1e-4
    bar."""
    reps, _, _ = report
    for rep in reps:
        c = rep["counts"][f"client_unify/{layout}"]
        assert c["calls"] == {"all_reduce": 1}, c
        assert c["psum"]["psum"] == 1
    assert all(all_ranks(reps, f"client_unify/{layout}/lams_close"))
    assert all(all_ranks(reps, f"client_unify/{layout}/bitwise"))


def test_round_stream_sharded(report):
    reps, _, _ = report
    assert all(all_ranks(reps, "round_stream/debug4x2"))


@pytest.mark.parametrize("name", ("plain", "coded", "chunked", "pipelined"))
def test_matu_strategy_sharded(report, name):
    """MaTUStrategy(mesh=) against MaTUStrategy(): task vectors close
    (and bitwise), masks equal, every upload and downlink and the wire
    bits equal — padding is traffic, not bits."""
    reps, _, _ = report
    for key in ("tv_close", "masks_equal", "bits", "tv_bitwise",
                "wire_bitwise"):
        assert all(all_ranks(reps, f"strategy/{name}/{key}")), key


@pytest.mark.parametrize("name, want", (("plain", 3), ("coded", 4),
                                        ("pipelined", 3)))
def test_strategy_gathers_at_wire_boundary(report, name, want):
    """The sharded batched step gathers at the drain only: the downlink
    vectors and words and the task vectors, and the uplink words where
    the coder reads them; nothing while a pipelined round is in
    flight."""
    reps, _, _ = report
    for rep in reps:
        c = rep["counts"][f"strategy/{name}"]
        assert c["gathers"] == want, c
        if name == "pipelined":
            assert c["at_dispatch"] == 0, c


def test_async_strategy_sharded(report):
    reps, _, _ = report
    assert all(all_ranks(reps, "async/task_vecs_bitwise"))
    assert all(all_ranks(reps, "async/wire_bitwise"))


def test_fed_simulator_sharded(report):
    """A 2-round FedSimulator(mesh=) on MLPBackbone: runs, same measured
    bits, task vectors close (and bitwise, with equal accuracies)."""
    reps, _, _ = report
    for key in ("ran", "bits", "tv_close", "bitwise"):
        assert all(all_ranks(reps, f"fedsim/{key}")), key


def test_population_simulator_sharded(report):
    reps, _, _ = report
    assert all(all_ranks(reps, "population/bitwise"))


def test_mesh_functions_refuse_as_jax(report):
    """More devices than ranks, or ``slots`` not dividing them: a
    ``ValueError``, as in the JAX package."""
    reps, _, _ = report
    assert all(all_ranks(reps, "mesh/refusals"))


def test_rank_failure_fails_the_run(tmp_path):
    """A rank that raises makes the whole run exit nonzero."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable,
                          os.path.join(HERE, "torch_sharded_ranks.py"),
                          str(tmp_path), "--fail"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "ProcessRaisedException" in out.stderr
