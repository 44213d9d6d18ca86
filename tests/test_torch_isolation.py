"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the port's
examples (``examples/*_torch.py``) import neither JAX nor the JAX package,
and the port's entry points refuse to run quietly on the CPU when no device
was named and CUDA is absent."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"
EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")

MODULES = [
    "repro_torch",
    "repro_torch.api",
    "repro_torch.api.backend",
    "repro_torch.api.events",
    "repro_torch.api.faults",
    "repro_torch.api.replicated",
    "repro_torch.api.service",
    "repro_torch.api.workload",
    "repro_torch.configs",
    "repro_torch.configs.xlstm_350m",
    "repro_torch.core",
    "repro_torch.core.gps",
    "repro_torch.engine",
    "repro_torch.engine.reference",
    "repro_torch.kernels",
    "repro_torch.kernels.chunk_attention",
    "repro_torch.kernels.decode_glue",
    "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.mlstm_chunk",
    "repro_torch.kernels.ops",
    "repro_torch.kernels.paged_attention",
    "repro_torch.kernels.ref",
    "repro_torch.kvcache",
    "repro_torch.launch",
    "repro_torch.launch.dryrun",
    "repro_torch.launch.mesh",
    "repro_torch.launch.op_analysis",
    "repro_torch.launch.serve",
    "repro_torch.launch.sharding",
    "repro_torch.launch.specs",
    "repro_torch.launch.train",
    "repro_torch.models",
    "repro_torch.models.layers",
    "repro_torch.models.params",
    "repro_torch.models.shardlib",
    "repro_torch.models.ssm",
    "repro_torch.models.transformer",
    "repro_torch.predictor",
    "repro_torch.predictor.heavy",
    "repro_torch.predictor.mlp",
    "repro_torch.predictor.service",
    "repro_torch.predictor.tfidf",
    "repro_torch.sim",
    "repro_torch.sim.cluster",
    "repro_torch.sim.metrics",
    "repro_torch.sim.reference",
    "repro_torch.training",
    "repro_torch.training.checkpoint",
    "repro_torch.training.data",
    "repro_torch.training.optimizer",
    "repro_torch.training.train",
    "repro_torch.trace",
    "repro_torch.tree",
    "repro_torch.workloads",
    "repro_torch.workloads.agents",
    "repro_torch.workloads.arrivals",
]


def test_port_and_smoke_import_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "import importlib.util\n"
        f"for p in {[str(p) for p in EXAMPLES]!r}:\n"
        "    spec = importlib.util.spec_from_file_location('example', p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('isolated')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "isolated"


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [SMOKE] + EXAMPLES,
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_or_repro_import_lines(path):
    """Every import line of the port, the smoke run and the examples."""
    for n, line in enumerate(path.read_text().splitlines(), 1):
        assert not FORBIDDEN.match(line), f"{path}:{n}: {line.strip()}"


def test_entry_points_raise_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.configs import get_config
    from repro_torch.core import make_scheduler
    from repro_torch.engine import ServeEngine
    from repro_torch.models import Model

    cfg = get_config("granite-3-2b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg)
    model = Model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model, model.init(), make_scheduler("justitia", 4096.0))


def test_predictor_and_training_entry_points_raise_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    import numpy as np

    from repro_torch.launch import train
    from repro_torch.predictor import (
        AgentCostPredictor,
        HeavyPredictor,
        MlpCostModel,
    )

    for call in (AgentCostPredictor,
                 lambda: MlpCostModel.train(np.zeros((4, 2)), np.ones(4)),
                 lambda: HeavyPredictor.train(["a b"], [1.0]),
                 lambda: train.run(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_cuda(alone, tmp_path):
    """Without a CUDA device (or without the repository beside it) the
    smoke run exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = SMOKE
    if alone:
        script = tmp_path / "chip_smoke.py"
        script.write_text(SMOKE.read_text())
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
