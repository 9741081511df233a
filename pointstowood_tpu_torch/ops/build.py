"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` is compiled on first use into
``build/torch_kernels/lib<name>-<hash>.so`` at the checkout root with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

and loaded with ``ctypes``. The sources expose plain C entry points
(pointers as ``c_void_p``, the stream from
``torch.cuda.current_stream().cuda_stream``) that return the launch's
``cudaGetLastError()``; ``check`` turns a non-zero code into an exception.
The file name carries a hash of the sources, so an edited kernel is never
served from a stale library. ``build_all`` starts one nvcc per source at
once. ``library(name, csrc)`` builds and loads the same entry points from
another source directory (an earlier tree's kernels, for timing two
versions in one process).

Nothing here runs at import time: this module is imported on machines
without nvcc, where only the plain PyTorch versions are used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("knn", "interp", "fusion", "group_min", "knn_dim", "fps",
           "stamp", "batchnorm")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of the entry points, by library.
_SIGNATURES = {
    "knn": {
        "ptw_knn_topk": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "ptw_knn_topk_above": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _P],
        "ptw_knn_top2_split": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "interp": {
        "ptw_interp_blend": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        "ptw_blend_bwd_lists": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _P],
        "ptw_blend_bwd_gather": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _P],
    },
    "fusion": {
        "ptw_pair_select": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    },
    "group_min": {
        "ptw_group_min": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "knn_dim": {
        "ptw_knn_topk_dim": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _P],
        "ptw_knn_dim_filter": [_P] * 13 + [_I] * 8 + [_P],
        "ptw_knn_dim_rescore": [_P] * 8 + [_I] * 6 + [_P],
        "ptw_knn_dim_exhaustive": [_P] * 6 + [_I] * 6 + [_P],
    },
    "fps": {
        "ptw_fps": [_P, _P, _P, _P, _I, _I, _I, _P],
    },
    "stamp": {
        "ptw_stamp": [_P, _I, _P],
    },
    "batchnorm": {
        "ptw_bn_reduce": [_I] + [_P] * 7 + [_L] + [_I] * 5 + [_P],
        "ptw_bn_finalize": [_P, _P, _I, _I, _P],
        "ptw_bn_elementwise": [_I] + [_P] * 9 + [_L] + [_I] * 4 + [_P],
    },
}

_LIBS: dict[tuple[str, str], ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str, csrc: Path | None = None) -> Path:
    digest = hashlib.sha256()
    for path in sorted(Path(csrc or CSRC).glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def build_all(names=SOURCES, verbose: bool = False,
              csrc: Path | None = None) -> dict[str, Path]:
    """Compile every missing library from ``csrc`` (default ``CSRC``),
    one nvcc process per source, all started together; returns name ->
    library path. Raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    paths = {}
    for name in names:
        out = _target(name, csrc)
        paths[name] = out
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(Path(csrc or CSRC) / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n{log}")
            continue
        if verbose and log:
            print(f"--- nvcc {name}.cu\n{log}", flush=True)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def library(name: str, csrc: Path | None = None) -> ctypes.CDLL:
    """The loaded library ``name`` built from ``csrc`` (default
    ``CSRC``), built first if needed."""
    key = (name, str(csrc))
    with _LOCK:
        if key not in _LIBS:
            _LIBS[key] = _load(name, build_all((name,), csrc=csrc)[name])
        return _LIBS[key]


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")
