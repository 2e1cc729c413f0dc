"""Build a native source of the package into a shared library and load it.

Each `csrc/<name>.cu` exposes a plain C interface. It is compiled with
`nvcc` for Hopper (`sm_90a`) at first use into `build/torch_ext/` at the
repository root, under a file name that carries the hash of the source and
the flags, so an edited source is rebuilt and a stale library is never
loaded. The library is opened with `ctypes`; PyTorch's headers are never
included, which keeps a build to seconds. A failed build raises.

`csrc/<name>.cpp` (host code: the augmentation engine) is built the same
way with the host C++ compiler (`CXX`, default g++) and the JAX package's
`native/Makefile` flags. Those include `-march=native`, so the hash also
covers the target features the compiler reports for this host: a library
built for another CPU is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # IEEE rounding that matches the plain PyTorch versions: no fast math,
    # no multiply-add contraction.
    "--fmad=false", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
)
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")
CXX_LIBS = ("-lpthread",)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (Path(cuda_home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError(f"nvcc not found (CUDA_HOME={cuda_home}, PATH)")


def _build(name: str, src: Path, compiler: list[str], flags: tuple, libs: tuple = (),
           key: bytes = b"") -> ctypes.CDLL:
    digest = hashlib.sha256(src.read_bytes() + " ".join(compiler + list(flags + libs)).encode()
                            + key).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}-{digest}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([*compiler, *flags, "-o", str(tmp), str(src), *libs],
                              capture_output=True, text=True, timeout=600)
        (BUILD_DIR / f"{name}.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{compiler[0]} failed for {src}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)  # atomic: a concurrent build never sees a partial file
    _loaded[name] = ctypes.CDLL(str(lib_path))
    return _loaded[name]


def load_library(name: str) -> ctypes.CDLL:
    """Compile (if needed) and load `csrc/<name>.cu`; cached per process."""
    if name in _loaded:
        return _loaded[name]
    return _build(name, CSRC / f"{name}.cu", [nvcc_path()], NVCC_FLAGS)


def load_host_library(name: str) -> ctypes.CDLL:
    """Compile (if needed) and load `csrc/<name>.cpp` with the host C++
    compiler; cached per process."""
    if name in _loaded:
        return _loaded[name]
    cxx = os.environ.get("CXX") or "g++"
    try:
        target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                                capture_output=True, text=True, timeout=60)
    except OSError as e:
        raise RuntimeError(f"host C++ compiler {cxx!r} not runnable: {e}") from e
    if target.returncode != 0 or not target.stdout.strip():
        raise RuntimeError(f"{cxx} did not report the target features of -march=native "
                           f"(exit {target.returncode}):\n{target.stderr}")
    return _build(name, CSRC / f"{name}.cpp", [cxx], CXX_FLAGS, CXX_LIBS,
                  key=target.stdout.encode())
