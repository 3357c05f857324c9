"""Build-cache reload check of the port's CUDA kernels (port of
tools/repro_cache_hang.py).

    python -m dustraytracer_tpu_torch.tools.repro_cache_hang [--timeout S]

The JAX package's tool asked whether a Pallas executable reloaded from
the persistent compilation cache hangs in a fresh process. The port's
cache is ops/cuda_build.py: a .so named by a hash of the source and the
flags, built by nvcc under an fcntl lock. This tool asks the same of it,
with csrc/add_salt.cu (o = x + SALT on an (8, 128) f32 block, beside its
plain twin x + SALT). Each run writes a copy of the source with its own
SALT into a fresh build directory under _build/, so no old cache entry
can answer for it, and runs four fresh child processes, each under a
timeout:

  A  builds the library and runs the kernel: bits equal to the twin's;
  B  loads it again: it must report built false and A's bits;
  C  gets a new salt and is killed with SIGKILL while its nvcc runs;
  D  the same source as C: it must get the lock, build, load and run.

D shows that a process that dies while building leaves no lock behind
that blocks the next process (the kernel drops an fcntl lock with its
holder; PyTorch's own lock-file build helper would leave its file). The
tool prints one JSON object and exits non-zero on a hang, a wrong
result, a rebuild in B or a cache hit in D. It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import torch

from dustraytracer_tpu_torch.ops.cuda_build import BUILD_DIR, CSRC

ROOT = Path(__file__).resolve().parents[2]
SHAPE = (8, 128)
LAUNCHES = 0  # add_salt kernel launches in this process


def add_salt(lib, x: torch.Tensor) -> torch.Tensor:
    """o = x + SALT by the kernel of `lib`, for a contiguous float32
    tensor on a CUDA card."""
    global LAUNCHES
    if x.device.type != "cuda" or x.dtype != torch.float32 \
            or not x.is_contiguous():
        raise ValueError("add_salt takes a contiguous float32 CUDA tensor")
    o = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.drt_add_salt(x.data_ptr(), o.data_ptr(), x.numel(),
                               torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"add_salt launch failed: "
                           f"{lib.drt_cuda_error_string(err).decode()}")
    LAUNCHES += 1
    return o


def add_salt_reference(x: torch.Tensor, salt: float) -> torch.Tensor:
    """The plain twin: x + SALT in float32 (the salt is exact in float32),
    one PyTorch call."""
    return x + salt


def child(src: Path, build_dir: Path) -> dict:
    """One process's check: load (building if needed), run, compare."""
    global LAUNCHES
    from dustraytracer_tpu_torch.ops.cuda_build import load_library
    from dustraytracer_tpu_torch.tools.grad_bench import device_ms

    rec = load_library("add_salt", src=src, build_dir=build_dir)
    lib = rec["lib"]
    p = ctypes.c_void_p
    lib.drt_add_salt.argtypes = [p, p, ctypes.c_int, p]
    lib.drt_add_salt.restype = ctypes.c_int
    lib.drt_add_salt_value.restype = ctypes.c_float
    lib.drt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.drt_cuda_error_string.restype = ctypes.c_char_p
    salt = float(lib.drt_add_salt_value())
    x = torch.arange(SHAPE[0] * SHAPE[1], dtype=torch.float32,
                     device="cuda").reshape(SHAPE)
    LAUNCHES = 0
    y = add_salt(lib, x)
    launches = LAUNCHES
    ref = add_salt_reference(x, salt)
    torch.cuda.synchronize()
    return {"built": rec["built"], "load_seconds": rec["seconds"],
            "salt": salt, "ok": bool(torch.equal(y, ref)),
            "max_abs_err": float((y - ref).abs().max()),
            "bits": hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest(),
            "launches": launches,
            "ms": device_ms(lambda: add_salt(lib, x), reps=20),
            "plain_ms": device_ms(lambda: add_salt_reference(x, salt),
                                  reps=20)}


def _write_source(build_dir: Path, salt: float) -> Path:
    src = build_dir / f"add_salt_{salt:.4f}.cu".replace(".", "_", 1)
    src.write_text(f"#define SALT {salt!r}f\n"
                   + (CSRC / "add_salt.cu").read_text())
    return src


def _nvcc_running(pid: int) -> bool:
    """Whether a direct child of `pid` is an nvcc process."""
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            stat = (entry / "stat").read_text()
            ppid = int(stat.rsplit(")", 1)[1].split()[1])
            cmd = (entry / "cmdline").read_bytes()
        except (OSError, ValueError, IndexError):
            continue
        if ppid == pid and b"nvcc" in cmd:
            return True
    return False


def _spawn(src: Path, build_dir: Path):
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen(
        [sys.executable, "-m", "dustraytracer_tpu_torch.tools."
         "repro_cache_hang", "--child", str(src), str(build_dir)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)


def _kill(proc) -> None:
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def _run_child(tag: str, src: Path, build_dir: Path, timeout: float,
               kill_in_nvcc: bool = False) -> dict:
    t0 = time.perf_counter()
    proc = _spawn(src, build_dir)
    if kill_in_nvcc:
        seen = False
        while proc.poll() is None and time.perf_counter() - t0 < timeout:
            if _nvcc_running(proc.pid):
                seen = True
                break
            time.sleep(0.01)
        _kill(proc)
        return {"child": tag, "killed_during_nvcc": seen,
                "seconds": time.perf_counter() - t0}
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        _kill(proc)
        return {"child": tag, "hung": True,
                "seconds": time.perf_counter() - t0}
    res = {"child": tag, "hung": False, "rc": proc.returncode,
           "seconds": time.perf_counter() - t0}
    if proc.returncode != 0:
        res["stderr"] = err[-2000:]
        return res
    res.update(json.loads(out.strip().splitlines()[-1]))
    return res


def run(timeout: float = 180.0) -> dict:
    """Run the four children; return {"ok", "children", "failures"}."""
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this check "
                           "builds and runs a CUDA kernel")
    tag = f"{os.getpid()}_{time.time_ns()}"
    build_dir = BUILD_DIR / f"cache_reload_{tag}"
    build_dir.mkdir(parents=True)
    salt = (time.time_ns() // 1000) % 100000 / 256.0  # exact in float32
    try:
        src1 = _write_source(build_dir, salt)
        src2 = _write_source(build_dir, salt + 0.5)
        kids = [_run_child("A", src1, build_dir, timeout),
                _run_child("B", src1, build_dir, timeout),
                _run_child("C", src2, build_dir, timeout, kill_in_nvcc=True),
                _run_child("D", src2, build_dir, timeout)]
    finally:
        shutil.rmtree(build_dir, ignore_errors=True)
    a, b, c, d = kids
    fails = []
    for kid in (a, b, d):
        if kid.get("hung"):
            fails.append(f"{kid['child']} hung past {timeout} s")
        elif kid.get("rc") != 0:
            fails.append(f"{kid['child']} exited {kid.get('rc')}")
        elif not kid["ok"]:
            fails.append(f"{kid['child']}: kernel differs from x + SALT")
    if not fails:
        if not a["built"]:
            fails.append("A did not build")
        if b["built"]:
            fails.append("B rebuilt instead of loading the cached library")
        if b["bits"] != a["bits"]:
            fails.append("B's bits differ from A's")
        if not c["killed_during_nvcc"]:
            fails.append("C was not caught in its nvcc")
        if not d["built"]:
            fails.append("D loaded a library that C never finished")
        if d["salt"] != salt + 0.5 or a["salt"] != salt:
            fails.append("a child ran another salt than its source's")
    return {"ok": not fails, "salt": salt, "timeout_s": timeout,
            "children": kids, "failures": fails}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="dustraytracer_tpu_torch.tools.repro_cache_hang")
    p.add_argument("--timeout", type=float, default=180.0,
                   help="seconds each child may take")
    p.add_argument("--child", nargs=2, metavar=("SRC", "BUILD_DIR"),
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        print(json.dumps(child(Path(args.child[0]), Path(args.child[1]))))
        return 0
    res = run(args.timeout)
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
