"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and the measured entry needs a card."""

import ast
import subprocess
import sys

import pytest
import torch

from benchmark import harness, run
from benchmark.tests import micro

FORBIDDEN = ("jax", "jaxlib", "flax", "protopformer_tpu")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(harness.ROOT)) for p in harness.BENCH.rglob("*.py")))
def test_no_file_imports_jax(path):
    tree = ast.parse((harness.ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names = [node.module or ""]
        else:
            continue
        assert not [n for n in names if n.split(".")[0] in FORBIDDEN]


_RUN = """
import sys, torch
from pathlib import Path
from benchmark import harness, run
from benchmark.tests import micro
root = micro.build(Path(sys.argv[1]))
for cell in ("micro.bulk", "micro.small", "micro.train"):
    assert run.main(["--workload", cell, "--seed", "5", "--seconds", "0.2",
                     "--trace", "1"], root=root,
                    device=torch.device("cpu")) == 0
print("FORBIDDEN", harness.loaded_forbidden())
print("PORT", "protopformer_tpu_torch" in sys.modules)
"""


def test_a_run_of_every_driver_loads_no_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", _RUN, str(tmp_path)],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=600, check=True).stdout
    assert "FORBIDDEN []" in out and "PORT True" in out


def reader_imports_jax(root):
    (root / "benchmark" / "metrics" / "mfu.serve_bulk.py").write_text(
        "import jax\n\ndef read(record):\n    return 1.0\n")


def check_imports_jax(root):
    path = root / "benchmark" / "compare.py"
    path.write_text(path.read_text() + (
        "\n_serve_numbers = serve_numbers\n\n\n"
        "def serve_numbers(*args, **kwargs):\n"
        "    import jax  # noqa: F401\n"
        "    return _serve_numbers(*args, **kwargs)\n"))


_STUB = """
import sys, torch
from pathlib import Path
from benchmark import run
sys.exit(run.main(["--workload", "micro.bulk", "--seed", "5", "--seconds",
                   "0.2", "--trace", "1"], root=Path.cwd(),
                  device=torch.device("cpu")))
"""


@pytest.mark.parametrize("plant", [reader_imports_jax, check_imports_jax])
def test_a_run_that_loads_jax_after_the_window_prints_no_result(tmp_path,
                                                                 plant):
    """A stub ``jax`` loaded by a per-layer reader, or by the check after
    the window, turns the run away with no result line."""
    root = micro.build(tmp_path)
    (tmp_path / "stub").mkdir()
    (tmp_path / "stub" / "jax.py").write_text("")
    plant(root)
    proc = subprocess.run(
        [sys.executable, "-c", _STUB], cwd=root, capture_output=True,
        text=True, timeout=600,
        env={"PYTHONPATH": f"{harness.ROOT}:{tmp_path / 'stub'}",
             "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == ""
    assert "the process holds JAX or the JAX package: jax" in proc.stderr


def test_loaded_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "protopformer_tpu_torch_extra", sys)
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "protopformer_tpu.models", sys)
    assert harness.loaded_forbidden() == ["protopformer_tpu.models"]


def test_the_measured_entry_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--workload", "deit_tiny224_cub.serve_bulk", "--seed", "1",
                  "--seconds", "1"])


def test_the_command_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "deit_tiny224_cub.serve_small", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
