"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` into an object, and the objects are linked into
``build/kernels/libppf_kernels.so`` at the root of the checkout. The
sources have a plain ``extern "C"`` interface and include no PyTorch
header, so a build takes seconds; the library is loaded with ``ctypes``.
A hash of the sources and flags is kept beside the library: a changed
source triggers a rebuild on first use, an unchanged one does not.

Nothing here runs at import time, so the CPU tests can import every
module without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libppf_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_LIB: Optional[ctypes.CDLL] = None

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float
# symbol -> argtypes; every launcher returns its cudaError_t as an int
_SIGNATURES = {
    "ppf_map_stats": [_VOIDP, _INT, _INT, _INT, _INT, _INT, _VOIDP, _VOIDP,
                      _VOIDP],
    "ppf_map_stats_smem_bytes": [_INT],
    "ppf_attention_block_stats": [_VOIDP, _INT, _INT, _INT, _INT, _INT, _INT,
                                  _FLOAT, _FLOAT, _VOIDP, _VOIDP, _VOIDP,
                                  _VOIDP, _VOIDP],
    "ppf_attention_block_stats_smem_bytes": [_INT, _INT],
    "ppf_attention_mean": [_VOIDP, _VOIDP, _INT, _INT, _INT, _INT, _INT, _INT,
                           _FLOAT, _FLOAT, _VOIDP, _VOIDP, _VOIDP],
    "ppf_attention_mean_smem_bytes": [_INT, _INT, _INT],
    "ppf_attention_core": [_VOIDP, _VOIDP, _INT, _INT, _INT, _INT, _INT, _INT,
                           _INT, _FLOAT, _FLOAT, _FLOAT, _FLOAT, _VOIDP,
                           _VOIDP, _VOIDP],
    "ppf_attention_core_smem_bytes": [_INT],
}

# shared memory one block may use on Hopper (sm_90), bytes
MAX_SMEM_PER_BLOCK = 232448


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels cannot be built"
        )
    return found


def sources_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def build(verbose: bool = False) -> Dict[str, object]:
    """Compile every source in parallel and link the shared library.

    Returns {"seconds", "rebuilt", "ptxas"}: ``ptxas`` holds the
    ``-Xptxas -v`` report per source when ``verbose``.
    """
    t0 = time.perf_counter()
    digest = sources_digest()
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    if (not verbose and lib_path.exists() and stamp.exists()
            and stamp.read_text().strip() == digest):
        return {"seconds": time.perf_counter() - t0, "rebuilt": False,
                "ptxas": {}}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    extra = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = {}
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            procs[src.name] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ), obj)
        reports, failed = {}, []
        for name, (proc, _obj) in procs.items():
            out, _ = proc.communicate()
            reports[name] = out
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(
                "nvcc failed for " + ", ".join(failed) + ":\n"
                + "\n".join(reports[n] for n in failed)
            )
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *(str(obj) for _p, obj in procs.values())],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError("linking the kernels failed:\n" + link.stdout)
        os.replace(tmp_lib, lib_path)
    stamp.write_text(digest + "\n")
    return {"seconds": time.perf_counter() - t0, "rebuilt": True,
            "ptxas": reports if verbose else {}}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _LIB
    if _LIB is None:
        build()
        lib = ctypes.CDLL(str(BUILD_DIR / LIB_NAME))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _INT
        _LIB = lib
    return _LIB


def check_launch(name: str, code: int) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {code}")


def check_smem(name: str, need: int) -> None:
    if need > MAX_SMEM_PER_BLOCK:
        raise ValueError(
            f"{name}: needs {need} bytes of shared memory per block, more "
            f"than the {MAX_SMEM_PER_BLOCK} a Hopper block may use"
        )
