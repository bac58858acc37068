"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
it runs on CUDA unless the caller asks for the CPU, and it never falls back
quietly from the card to the CPU."""

import ast
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "protopformer_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "protopformer_tpu")


def _forbidden(name: str) -> bool:
    # exact names: ``protopformer_tpu_torch`` starts with ``protopformer_tpu``
    return any(name == m or name.startswith(m + ".") for m in FORBIDDEN)


_IMPORT_ALL = f"""
import importlib, pkgutil, sys
import protopformer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if any(m == f or m.startswith(f + ".") for f in {FORBIDDEN!r}))
print(len(names), bad)
"""


def test_importing_every_module_pulls_in_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, check=True,
        capture_output=True, text=True, timeout=300,
    ).stdout.split()
    assert int(out[0]) >= 20  # every module of the port was imported
    assert out[1:] == ["[]"]


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]
))
def test_no_source_imports_jax(path):
    """Also catches imports inside functions, which the runtime check only
    sees when the function runs."""
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.append(node.module)
    assert not [n for n in names if _forbidden(n)]


def test_forbidden_name_check_is_exact():
    assert _forbidden("protopformer_tpu") and _forbidden("protopformer_tpu.ops")
    assert _forbidden("jax.numpy") and not _forbidden("jaxtyping")
    assert not _forbidden("protopformer_tpu_torch.ops")


def test_serving_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from protopformer_tpu_torch.core.config import PPNetConfig, backbone_preset
    from protopformer_tpu_torch.serving import ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(backbone_preset("deit_micro_test"), PPNetConfig(), {})


def test_bench_cli_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from protopformer_tpu_torch.cli import bench_kernels

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_kernels.run()


def test_kernels_have_no_path_for_other_devices():
    from protopformer_tpu_torch.kernels import (
        fused_attention_block_stats,
        fused_attention_core,
        fused_attention_core_padded,
        fused_attention_mean_padded,
        fused_map_stats,
    )

    meta = torch.device("meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        fused_map_stats(torch.empty((2, 8, 8), device=meta), 0.9)
    with pytest.raises(RuntimeError, match="no kernel"):
        fused_attention_block_stats(
            torch.empty((2, 8, 12), device=meta, dtype=torch.bfloat16), 2
        )
    with pytest.raises(RuntimeError, match="no kernel"):
        fused_attention_mean_padded(
            torch.empty((2, 8, 12), device=meta), torch.empty((2, 8)), 2, 8
        )
    with pytest.raises(RuntimeError, match="no kernel"):
        fused_attention_core(torch.empty((2, 8, 12), device=meta), None, 2)
    with pytest.raises(RuntimeError, match="no kernel"):
        fused_attention_core_padded(
            torch.empty((2, 8, 12), device=meta), torch.empty((2, 8)), 2, 6
        )


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path, alone):
    """``chip_smoke.py`` prints no result and exits non-zero where there is
    no CUDA device, and where the package is not beside it."""
    script = ROOT / "chip_smoke.py"
    if alone:
        script = pathlib.Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    if torch.cuda.is_available() and not alone:
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
