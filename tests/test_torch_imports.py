"""The port imports without JAX, and its CLI renders on the CPU and
refuses a CUDA device that is absent."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def _run(code: str):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_without_jax():
    proc = _run(
        "import sys\n"
        "import dustraytracer_tpu_torch\n"
        "import dustraytracer_tpu_torch.render.integrator\n"
        "import dustraytracer_tpu_torch.render.film\n"
        "import dustraytracer_tpu_torch.apps.cli\n"
        "import dustraytracer_tpu_torch.apps.optimize\n"
        "import dustraytracer_tpu_torch.parallel.shard\n"
        "import dustraytracer_tpu_torch.utils.checkpoint\n"
        "import dustraytracer_tpu_torch.interop\n"
        "import dustraytracer_tpu_torch.utils.image\n"
        "import dustraytracer_tpu_torch.tools.grad_bench\n"
        "import dustraytracer_tpu_torch.tools.repro_cache_hang\n"
        "import dustraytracer_tpu_torch.ops.traverse\n"
        "import dustraytracer_tpu_torch.ops.traverse_brute\n"
        "import dustraytracer_tpu_torch.ops.traverse_cluster\n"
        "import dustraytracer_tpu_torch.ops.traverse_pallas\n"
        "import dustraytracer_tpu_torch.utils.roofline\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'dustraytracer_tpu' or m.startswith('dustraytracer_tpu.')]"
        "\nassert not bad, bad\n"
        "print('ok')\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.fixture(scope="module")
def glb(tmp_path_factory):
    from chip_smoke import write_glb
    from dustraytracer_tpu_torch.scene.gltf import GltfDocument
    from tests.util_scenes import make_random_tri_doc

    doc = make_random_tri_doc(600, seed=5)
    path = tmp_path_factory.mktemp("cli") / "soup.glb"
    write_glb(path, GltfDocument(meshes=doc.meshes, materials=doc.materials,
                                 images=[], cameras=[]))
    return path


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "dustraytracer_tpu_torch.apps.cli", "render",
         *map(str, args)], cwd=ROOT, capture_output=True, text=True,
        timeout=300)


def test_cli_renders_on_cpu(glb, tmp_path):
    out = tmp_path / "img.png"
    proc = _cli("--scene", glb, "--size", "24x16", "--spp", "2",
                "--bounces", "2", "--camera-pos", "0,0,14", "--look-at",
                "0,0,0", "--device", "cpu", "--out", out)
    assert proc.returncode == 0, proc.stderr
    metrics = json.loads(proc.stdout)
    for key in ("scene", "triangles", "size", "spp", "bounces",
                "ingest_seconds", "compile_seconds", "render_seconds",
                "samples_per_second", "mrays_per_second", "devices", "out"):
        assert key in metrics, key
    assert metrics["triangles"] == 600 and metrics["spp"] == 2
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_cli_cuda_without_card_raises(glb, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot be shown")
    proc = _cli("--scene", glb, "--size", "8x8", "--spp", "1",
                "--out", tmp_path / "x.png")
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert not (tmp_path / "x.png").exists()


@pytest.mark.parametrize("flag", [["--devices", "2"],
                                  ["--checkpoint", "film.npz"],
                                  ["--debug-view", "bvh"]])
def test_cli_not_ported_flags_raise(glb, tmp_path, flag):
    proc = _cli("--scene", glb, "--device", "cpu", "--out",
                tmp_path / "x.png", *flag)
    assert proc.returncode != 0
    assert "not yet ported" in proc.stderr
