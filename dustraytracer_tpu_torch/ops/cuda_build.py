"""Build a CUDA source of `csrc/` into a shared library and load it.

Each kernel is a plain `extern "C"` entry compiled by nvcc for Hopper
(`sm_90a`) and bound with ctypes: no PyTorch headers, so a build takes
seconds. Libraries go to `dustraytracer_tpu_torch/_build/`, named by a
hash of the source and the flags, so an edit rebuilds and an unchanged
source loads the cached file. A file lock per library serialises
concurrent builds of one source (test workers, a CLI subprocess), while
different sources build in parallel. A failed build raises with nvcc's
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

# (name, source, build dir) as the caller gave them -> {"lib": CDLL,
# "path", "seconds", "built", "log"}; one entry per source for the life
# of the process. Every kernel launch looks its library up here, so the
# key takes no filesystem call.
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


def load_library(name: str, src: Path | None = None,
                 build_dir: Path | None = None) -> dict:
    """Build (if needed) and load `csrc/<name>.cu`, or the source `src`,
    into `_build/` or `build_dir`; return its record {"lib", "path",
    "seconds", "built", "log"}. Cached per process.

    The lock is an fcntl lock on the library's `.lock` file: the kernel
    drops it when its holder dies, so a process killed mid-build blocks
    no later process (tools/repro_cache_hang.py checks it)."""
    key = (name, src, build_dir)
    if key in _LOADED:
        return _LOADED[key]
    src = Path(src) if src is not None else CSRC / f"{name}.cu"
    build_dir = Path(build_dir) if build_dir is not None else BUILD_DIR
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    build_dir.mkdir(parents=True, exist_ok=True)
    lib_path = build_dir / f"lib{name}_{digest}.so"
    log_path = lib_path.with_suffix(".log")
    t0 = time.perf_counter()
    built = False
    with open(lib_path.with_suffix(".lock"), "w") as lock:
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
    _LOADED[key] = rec
    return rec
