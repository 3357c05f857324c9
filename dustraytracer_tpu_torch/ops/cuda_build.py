"""Build a CUDA source of `csrc/` into a shared library and load it.

Each kernel is a plain `extern "C"` entry compiled by nvcc for Hopper
(`sm_90a`) and bound with ctypes: no PyTorch headers, so a build takes
seconds. Libraries go to `dustraytracer_tpu_torch/_build/`, named by a
hash of the source and the flags, so an edit rebuilds and an unchanged
source loads the cached file. A file lock serialises concurrent builds
(test workers, a CLI subprocess). A failed build raises with nvcc's
output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH = "sm_90a"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# name -> {"lib": CDLL, "path", "seconds", "built", "log"}; one entry per
# source for the life of the process
_LOADED: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        exe = Path(cand) / "bin" / "nvcc"
        if cand and exe.is_file():
            return str(exe)
    exe = shutil.which("nvcc")
    if exe is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH): the CUDA kernels cannot be built")
    return exe


def load_library(name: str) -> dict:
    """Build (if needed) and load `csrc/<name>.cu`; return its record
    {"lib", "path", "seconds", "built", "log"}. Cached per process."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"lib{name}_{digest}.so"
    log_path = lib_path.with_suffix(".log")
    t0 = time.perf_counter()
    built = False
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib_path.exists():
            tmp = lib_path.with_suffix(f".tmp{os.getpid()}")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
            log_path.write_text(log)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed for {src.name} "
                                   f"(rc {proc.returncode}):\n{log}")
            os.replace(tmp, lib_path)
            built = True
    rec = {"lib": ctypes.CDLL(str(lib_path)), "path": str(lib_path),
           "seconds": time.perf_counter() - t0, "built": built,
           "log": log_path.read_text() if log_path.exists() else ""}
    _LOADED[name] = rec
    return rec
