"""The port's training launcher (``repro_torch.launch.train``) against the
JAX package's (``repro.launch.train``), on the CPU.

* the flags: both modes' options, defaults and choices, read off each
  parser's ``--help``, are the reference's;
* ``fed`` on a small MLP setting (4 tasks, 4 clients, 2 rounds, the
  other flags at their defaults): the final mean accuracy within 0.02 of
  JAX's and the uplink bits of every round equal (JAX's run comes from a
  subprocess that records the ``History`` its ``run_fed`` builds);
* ``lm`` runs 2 steps of the reduced granite with finite losses.
"""

import os
import pickle
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import train as ttrain  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FED_ARGS = ["fed", "--tasks", "4", "--clients", "4", "--rounds", "2"]

_JAX = textwrap.dedent("""
    import pickle, sys
    from repro.fed import simulator
    from repro.launch import train
    runs = []
    run = simulator.FedSimulator.run

    def recording(self, *a, **kw):
        hist = run(self, *a, **kw)
        runs.append(hist)
        return hist
    simulator.FedSimulator.run = recording
    sys.argv = ["train"] + sys.argv[2:]
    train.main()
    h = runs[-1]
    pickle.dump({"final": float(h.final_mean_acc),
                 "bits": [int(b) for b in h.uplink_bits_per_round]},
                open(OUT_PATH, "wb"))
""")


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def jax_fed(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("launch") / "jax_fed.pkl")
    script = _JAX.replace("OUT_PATH", repr(out))
    proc = subprocess.Popen([sys.executable, "-c", script, "x", *FED_ARGS],
                            env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _options(help_text):
    """{option: its help line's text after the option} of a --help."""
    opts = {}
    for m in re.finditer(r"^\s+(--[\w-]+)(.*)$", help_text, re.M):
        opts[m.group(1)] = m.group(2).strip()
    return opts


@pytest.mark.parametrize("mode", ("fed", "lm"))
def test_flags_are_the_references(mode):
    helps = []
    for pkg in ("repro", "repro_torch"):
        out = subprocess.run([sys.executable, "-m", f"{pkg}.launch.train",
                              mode, "--help"], env=_env(),
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        helps.append(_options(out.stdout))
    assert helps[1] == helps[0] and helps[0]
    args = ttrain.parser().parse_args([mode])
    if mode == "lm":
        assert args.reduced is True and args.arch == "qwen2-0.5b"
    else:
        assert (args.tasks, args.clients, args.rounds, args.local_steps,
                args.lr) == (8, 16, 40, 30, 1e-2)


def test_fed_matches_jax(jax_fed):
    proc, out = jax_fed
    hist = ttrain.main(FED_ARGS, device="cpu")
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    with open(out, "rb") as f:
        want = pickle.load(f)
    assert abs(hist.final_mean_acc - want["final"]) <= 0.02, (
        hist.final_mean_acc, want["final"])
    assert [int(b) for b in hist.uplink_bits_per_round] == want["bits"]
    assert len(want["bits"]) == 2


def test_lm_runs_two_steps():
    losses = ttrain.main(["lm", "--arch", "granite-moe-3b-a800m", "--steps",
                          "2"], device="cpu")
    assert len(losses) == 2 and np.all(np.isfinite(losses))
