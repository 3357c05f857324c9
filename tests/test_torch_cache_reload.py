"""The port's kernel build cache (ops/cuda_build.py), which
tools/repro_cache_hang.py checks on the card with a real nvcc: here a
stand-in compiler script, which copies an existing shared library to
its output, lets the CPU run the same sequence in fresh processes (build,
reload from the cache, a build killed inside its compiler, a rebuild
that must not wait on the dead one's lock). The add_salt kernel's source
and the tool's refusal without a card are checked too."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from dustraytracer_tpu_torch.ops.cuda_build import CSRC
from dustraytracer_tpu_torch.tools import repro_cache_hang as rch

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture()
def fake_cuda(tmp_path):
    """A CUDA_HOME whose bin/nvcc sleeps $FAKE_NVCC_SLEEP seconds, then
    copies a loadable shared library to its -o argument."""
    import _ctypes

    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(
        "#!/bin/sh\n"
        "sleep ${FAKE_NVCC_SLEEP:-0}\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = \"-o\" ]; then out=\"$2\"; fi\n"
        "  shift\n"
        "done\n"
        f"cp '{_ctypes.__file__}' \"$out\"\n")
    nvcc.chmod(0o755)
    return tmp_path / "cuda"


def _loader(src, build_dir, cuda_home, sleep=0):
    code = ("import json, sys\n"
            "from dustraytracer_tpu_torch.ops.cuda_build import load_library\n"
            "rec = load_library('k', src=sys.argv[1], build_dir=sys.argv[2])\n"
            "print(json.dumps({'built': rec['built']}))\n")
    env = dict(os.environ, CUDA_HOME=str(cuda_home),
               FAKE_NVCC_SLEEP=str(sleep),
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen([sys.executable, "-c", code, str(src),
                             str(build_dir)], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)


def _built(proc, timeout=60):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err
    return json.loads(out.strip().splitlines()[-1])["built"]


def test_cache_reload_and_a_killed_build(fake_cuda, tmp_path):
    build = tmp_path / "build"
    src1, src2 = tmp_path / "a.cu", tmp_path / "b.cu"
    src1.write_text("// one\n")
    src2.write_text("// two\n")
    assert _built(_loader(src1, build, fake_cuda)) is True      # A
    assert _built(_loader(src1, build, fake_cuda)) is False     # B
    killed = _loader(src2, build, fake_cuda, sleep=60)          # C
    t0 = time.perf_counter()
    while not rch._nvcc_running(killed.pid):
        assert killed.poll() is None and time.perf_counter() - t0 < 60
        time.sleep(0.02)
    rch._kill(killed)
    assert killed.returncode == -9
    t0 = time.perf_counter()
    assert _built(_loader(src2, build, fake_cuda), timeout=30) is True  # D
    assert time.perf_counter() - t0 < 30  # no wait on C's lock
    assert len(list(build.glob("libk_*.so"))) == 2


def test_salted_source(tmp_path):
    src = rch._write_source(tmp_path, 123.25)
    text = src.read_text()
    assert text.startswith("#define SALT 123.25f\n")
    assert text.endswith((CSRC / "add_salt.cu").read_text())
    assert float(torch.tensor(123.25, dtype=torch.float32)) == 123.25


def test_add_salt_twin_and_wrapper_checks():
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128)
    assert torch.equal(rch.add_salt_reference(x, 0.5), x + 0.5)
    before = rch.launches()
    with pytest.raises(ValueError):
        rch.add_salt(None, x)  # a CPU tensor never reaches the kernel
    assert rch.launches() == before


def test_tool_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot be shown")
    with pytest.raises(RuntimeError, match="is_available"):
        rch.run(timeout=5)
