"""Package rules of the PyTorch port (``src/repro_torch``):

* nothing under ``src/repro_torch/`` or ``chip_smoke.py`` imports ``jax``
  or the JAX package ``repro`` (an AST scan);
* the numpy-only ``data/dirichlet.py`` and ``fed/systems.py`` are
  byte-identical copies;
* every entry point defaults to ``device="cuda"`` and raises without a
  card instead of running on the CPU.
"""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core.engine import (EngineConfig, RoundEngine,  # noqa: E402
                                     batched_client_unify, pack_uploads)
from repro_torch.core.server import MaTUServer, MaTUServerConfig  # noqa: E402
from repro_torch.fed.simulator import FedConfig, FedSimulator  # noqa: E402
from repro_torch.fed.strategies import (AsyncMaTUStrategy,  # noqa: E402
                                        FedAvgStrategy, MaTUStrategy)
from repro_torch.serve import ModulatorStore, MultiTenantDecoder  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


def forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in imported_modules(path) if forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_scan_sees_the_whole_port():
    names = {p.name for p in PORT_FILES}
    for must in ("ops.py", "engine.py", "strategies.py", "simulator.py",
                 "router.py", "lm.py", "attention.py", "ssm.py",
                 "mlstm_chunk.py", "xlstm_1_3b.py", "systems.py",
                 "chip_smoke.py"):
        assert must in names
    assert forbidden("jax.numpy") and forbidden("repro.core")
    assert not forbidden("repro_torch.core")


def test_dirichlet_is_a_byte_identical_copy():
    a = (ROOT / "src" / "repro" / "data" / "dirichlet.py").read_bytes()
    b = (ROOT / "src" / "repro_torch" / "data" / "dirichlet.py").read_bytes()
    assert a == b


def test_systems_is_a_byte_identical_copy():
    a = (ROOT / "src" / "repro" / "fed" / "systems.py").read_bytes()
    b = (ROOT / "src" / "repro_torch" / "fed" / "systems.py").read_bytes()
    assert a == b


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


ENTRY_POINTS = {
    "RoundEngine": lambda: RoundEngine(EngineConfig(n_tasks=3)),
    "MaTUServer": lambda: MaTUServer(MaTUServerConfig(n_tasks=3)),
    "MaTUStrategy": lambda: MaTUStrategy(3, 64),
    "AsyncMaTUStrategy": lambda: AsyncMaTUStrategy(3, 64),
    "FedSimulator (systems)": lambda: _async_simulator(),
    "FedAvgStrategy": lambda: FedAvgStrategy(3, 64),
    "batched_client_unify": lambda: batched_client_unify(
        torch.zeros(2, 2, 64), torch.ones(2, 2, dtype=torch.bool)),
    "pack_uploads": lambda: pack_uploads([_upload()], 3),
    "build_model": lambda: _qwen().build(),
    "build_model (xlstm)": lambda: _xlstm().build(),
    "LM": lambda: _qwen().build(device="cpu").model.__class__(
        vocab=8, d_model=8, n_units=1, unit_blocks=[]),
    "ModulatorStore": lambda: ModulatorStore(_space(), {}),
    "MultiTenantDecoder": lambda: MultiTenantDecoder(None, {}, None),
}


def _async_simulator():
    from repro_torch.data.dirichlet import dirichlet_split
    from repro_torch.data.synthetic import make_constellation
    from repro_torch.fed.systems import ClientSystems
    from repro_torch.fed.testbed import MLPBackbone
    con = make_constellation(n_tasks=2, n_groups=1, feat_dim=4, n_classes=2)
    split = dirichlet_split(n_clients=2, n_tasks=2, n_classes=2,
                            tasks_per_client=1)
    bb = MLPBackbone(4, hidden=8, lora_rank=2)
    return FedSimulator(FedConfig(rounds=1), con, split, bb,
                        AsyncMaTUStrategy(2, bb.d, device="cpu"),
                        systems=ClientSystems.ideal(2))


def _qwen():
    from repro_torch.configs.base import load_arch
    return load_arch("qwen2-0.5b").reduced()


def _xlstm():
    from repro_torch.configs.base import load_arch
    return load_arch("xlstm-1.3b").reduced()


def _space():
    from repro_torch.common.tree import TaskVectorSpace
    return TaskVectorSpace.from_tree({"a": torch.zeros(4)})


def _upload():
    from repro_torch.core.client import ClientUpload
    return ClientUpload(0, [0], torch.zeros(64), torch.zeros(1, 2,
                        dtype=torch.int32), torch.ones(1), [1])


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda_and_raise_without_a_card(no_cuda, name):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name]()


def test_simulator_defaults_to_cuda(no_cuda):
    from repro_torch.data.dirichlet import dirichlet_split
    from repro_torch.data.synthetic import make_constellation
    from repro_torch.fed.testbed import MLPBackbone
    con = make_constellation(n_tasks=2, n_groups=1, feat_dim=4, n_classes=2)
    split = dirichlet_split(n_clients=2, n_tasks=2, n_classes=2,
                            tasks_per_client=1)
    bb = MLPBackbone(4, hidden=8, lora_rank=2)
    strat = MaTUStrategy(2, bb.d, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FedSimulator(FedConfig(rounds=1), con, split, bb, strat)


def test_entry_points_run_on_the_cpu_when_asked():
    eng = RoundEngine(EngineConfig(n_tasks=3), device="cpu")
    assert eng.device.type == "cpu"
    uni, words, lams = batched_client_unify(
        torch.randn(2, 2, 64), torch.ones(2, 2, dtype=torch.bool),
        device="cpu")
    assert uni.dtype == torch.bfloat16 and words.dtype == torch.int32
    assert lams.shape == (2, 2)
