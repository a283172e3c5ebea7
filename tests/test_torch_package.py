"""The port stands alone and runs where it is told: it imports nothing of JAX
or of the JAX package, and its entry points refuse to run on the CPU unless
asked to."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from crabml_tpu_torch import cli
from crabml_tpu_torch.errors import ConfigError
from crabml_tpu_torch.runtime.runner import Runner

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "crabml_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _foreign(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "crabml_tpu")


def test_import_leaves_jax_and_the_jax_package_out():
    code = (
        "import sys, crabml_tpu_torch, crabml_tpu_torch.runtime.runner, crabml_tpu_torch.cli\n"
        "import crabml_tpu_torch.tools.synth_gguf, crabml_tpu_torch.serving\n"
        "import crabml_tpu_torch.serving.http, crabml_tpu_torch.ops.cuda.paged_decode_attention\n"
        "print('\\n'.join(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True).stdout.split()
    assert "crabml_tpu_torch.runtime.runner" in out
    assert "crabml_tpu_torch.serving.paged" in out and "crabml_tpu_torch.serving.http" in out
    assert [m for m in out if _foreign(m)] == []


def test_scan_covers_the_serving_modules():
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {"crabml_tpu_torch/serving/engine.py", "crabml_tpu_torch/serving/paged.py",
            "crabml_tpu_torch/serving/http.py", "crabml_tpu_torch/serving/__init__.py",
            "crabml_tpu_torch/ops/cuda/paged_decode_attention.py", "chip_smoke.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_foreign(path):
    """Every import statement, lazy ones inside functions included."""
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module]
    assert [m for m in names if _foreign(m)] == []


def test_runner_without_device_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="CUDA is not available"):
        Runner(str(tmp_path / "never_opened.gguf"))
    with pytest.raises(ConfigError, match="CUDA is not available"):
        cli.main([str(tmp_path / "never_opened.gguf"), "-n", "2"])


def test_serving_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """ServingEngine, PagedServingEngine and the daemon run on the card unless
    asked for the CPU: here, with no card, they raise before loading a model."""
    from crabml_tpu_torch.models.config import ModelConfig
    from crabml_tpu_torch.serving import PagedServingEngine, ServingEngine
    from crabml_tpu_torch.serving import http as serving_http

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(architecture="llama", embedding_dim=256, n_heads=2, n_kv_heads=1,
                      n_layers=1, vocab_size=8, seq_len=128)
    for engine in (ServingEngine, PagedServingEngine):
        with pytest.raises(ConfigError, match="CUDA is not available"):
            engine(weights={}, cfg=cfg)
    with pytest.raises(ConfigError, match="CUDA is not available"):
        serving_http.main([str(tmp_path / "never_opened.gguf"), "--port", "0"])
