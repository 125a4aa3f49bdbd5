"""Build and load the port's CUDA kernels.

Each kernel is one source `csrc/<name>.cu` with a plain C entry point.
It is compiled with nvcc for sm_90a into a shared library under
`build/kernels/` at the root of the checkout, named after the content
hash of the source and the flags (a rebuild happens only when either
changes), and loaded with ctypes. Nothing is built or loaded at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

SOURCE_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_loaded: Dict[str, ctypes.CDLL] = {}  # kernel name -> its loaded library


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME)")
    return nvcc


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` is built: named after its content hash."""
    src = (SOURCE_DIR / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libmadrigal_{name}_{tag}.so"


def build(names: Sequence[str], verbose: bool = False,
          seconds: Dict[str, float] | None = None) -> Dict[str, Path]:
    """Compile every `csrc/<name>.cu` not built yet, one nvcc process per
    source, all started together, and return {name: library path}. With
    verbose, nvcc's -Xptxas -v report is printed; `seconds` receives the
    wall time from the start until each build was done (0 when none was
    needed)."""
    if seconds is not None:
        seconds.update({n: 0.0 for n in names})
    libs = {n: library_path(n) for n in names}
    todo = {n: lib for n, lib in libs.items() if not lib.exists()}
    if not todo:
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for n, lib in todo.items():
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
               str(SOURCE_DIR / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}.cu: nvcc failed ({proc.returncode}):\n{err}")
            continue
        os.replace(tmp, todo[n])
        if seconds is not None:
            seconds[n] = time.perf_counter() - t0
        if verbose:
            print(f"built {todo[n].name} in {time.perf_counter() - t0:.1f} s")
            print(err.strip())
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load(name: str, symbol: str, argtypes: Sequence) -> ctypes.CDLL:
    """The library of `csrc/<name>.cu`, built if needed, with `symbol`
    declared to take `argtypes` and to return an int (a cudaError_t)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check_operand(name: str, t, shape: tuple, device,
                  align: int = 16) -> None:
    """Raise unless `t` lies on `device` with `shape`, contiguous and
    `align`-byte aligned, as the kernels read it."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(
            f"{name} must be contiguous and {align}-byte aligned")
