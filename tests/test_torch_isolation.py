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


def test_the_checks_cover_the_data_layer():
    """The import walk and the source scan above both reach each module of
    the data layer (its loader, transforms, native binding and mixup)."""
    import pkgutil

    import protopformer_tpu_torch.data as data

    walked = {m.name for m in pkgutil.walk_packages(data.__path__,
                                                    data.__name__ + ".")}
    scanned = {p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")}
    for mod in ("datasets", "loader", "local_parts", "mixup", "native",
                "preprocess", "transforms"):
        assert f"protopformer_tpu_torch.data.{mod}" in walked
        assert f"protopformer_tpu_torch/data/{mod}.py" in scanned


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


@pytest.mark.parametrize("entry", ["make_train_step", "create_train_state",
                                   "make_eval_step"])
def test_train_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch, entry):
    from protopformer_tpu_torch import train
    from protopformer_tpu_torch.core.config import (
        OptimConfig,
        PPNetConfig,
        backbone_preset,
    )
    from protopformer_tpu_torch.models import construct_ppnet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pp = PPNetConfig(prototype_shape=(40, 16, 1, 1), num_classes=4,
                     reserve_layers=(2,), reserve_token_nums=(9,),
                     global_proto_per_class=3)
    model = construct_ppnet(backbone_preset("deit_micro_test"), pp)
    calls = {
        "make_train_step": lambda: train.make_train_step(
            model, pp, OptimConfig()),
        "create_train_state": lambda: train.create_train_state(
            model, train.make_optimizer(OptimConfig(), model, 1)),
        "make_eval_step": lambda: train.make_eval_step(),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


@pytest.mark.parametrize("entry", ["construct_basenet",
                                   "construct_distilled_deit",
                                   "push_forward"])
def test_model_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch, entry):
    """``BaseNet`` and ``DistilledDeiT`` are built by their constructors
    on CUDA; ``push_forward`` is served by ``ServingEngine``, which
    defaults to CUDA."""
    from protopformer_tpu_torch import models
    from protopformer_tpu_torch.core.config import PPNetConfig, backbone_preset
    from protopformer_tpu_torch.serving import ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bk = backbone_preset("deit_micro_test")
    calls = {
        "construct_basenet": lambda: models.construct_basenet(bk),
        "construct_distilled_deit": lambda: models.construct_distilled_deit(
            backbone_preset("deit_micro_test", distilled=True)),
        "push_forward": lambda: ServingEngine(bk, PPNetConfig(), {}
                                              ).push_forward,
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_default_gates_never_take_the_plain_structure(monkeypatch, dtype):
    """The kernel-off structure is a configuration, never a fallback: with
    the default gates ("auto") an eval forward on a CUDA request goes to
    the kernel wrappers and never runs the headloop, and a wrapper that
    raises (a kernel that fails to build or launch) is not caught. The
    wrappers are stubs here: their CUDA launch needs a card."""
    from protopformer_tpu_torch.core.config import PPNetConfig, backbone_preset
    from protopformer_tpu_torch.models import construct_ppnet, deit, layers

    model = construct_ppnet(
        backbone_preset("deit_micro_test"),
        PPNetConfig(prototype_shape=(40, 16, 1, 1), num_classes=4,
                    reserve_layers=(2,), reserve_token_nums=(9,),
                    global_proto_per_class=3), dtype)
    headloop = []
    monkeypatch.setattr(layers.Attention, "_headloop",
                        lambda *a, **k: headloop.append(1))

    def broken(*args, **kwargs):
        raise RuntimeError("kernel build failed: no nvcc")

    for module, name in ((layers, "fused_attention_block_stats"),
                         (layers, "fused_attention_mean_padded"),
                         (layers, "fused_attention_core"),
                         (deit, "fused_map_stats")):
        monkeypatch.setattr(module, name, broken)
    with pytest.raises(RuntimeError, match="kernel build failed"), \
            torch.inference_mode():
        model(torch.zeros((2, 32, 32, 3)))
    assert not headloop


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
