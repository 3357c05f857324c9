"""The port imports without JAX; its CLI renders on the CPU (debug
views and film checkpoints as the JAX package renders them), prints
scene statistics, and refuses a CUDA device that is absent."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
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
        "import dustraytracer_tpu_torch.diff.fd\n"
        "import dustraytracer_tpu_torch.render.texture\n"
        "import dustraytracer_tpu_torch.parallel.shard\n"
        "import dustraytracer_tpu_torch.parallel.mesh\n"
        "import dustraytracer_tpu_torch.parallel.multihost\n"
        "import dustraytracer_tpu_torch.utils.profiling\n"
        "import dustraytracer_tpu_torch.apps.viewer\n"
        "import dustraytracer_tpu_torch.accel.native.build\n"
        "import dustraytracer_tpu_torch.utils.checkpoint\n"
        "import dustraytracer_tpu_torch.interop\n"
        "import dustraytracer_tpu_torch.utils.image\n"
        "import dustraytracer_tpu_torch.tools.grad_bench\n"
        "import dustraytracer_tpu_torch.tools.repro_cache_hang\n"
        "import dustraytracer_tpu_torch.tools.tuning\n"
        "import dustraytracer_tpu_torch.tools.profile_stages\n"
        "import dustraytracer_tpu_torch.tools.bisect_segment\n"
        "import dustraytracer_tpu_torch.tools.retune_fetch\n"
        "import dustraytracer_tpu_torch.tools.bench_anyhit_sort\n"
        "import dustraytracer_tpu_torch.tools.bench_cluster_k\n"
        "import dustraytracer_tpu_torch.tools.attr_sweep\n"
        "import dustraytracer_tpu_torch.ops.traverse\n"
        "import dustraytracer_tpu_torch.ops.traverse_brute\n"
        "import dustraytracer_tpu_torch.ops.traverse_cluster\n"
        "import dustraytracer_tpu_torch.ops.traverse_pallas\n"
        "import dustraytracer_tpu_torch.utils.roofline\n"
        "import dustraytracer_tpu_torch.ops.peaks\n"
        "import dustraytracer_tpu_torch.ops.rows\n"
        "import dustraytracer_tpu_torch.tools.bench\n"
        "import dustraytracer_tpu_torch.tools.bench_scenes\n"
        "import dustraytracer_tpu_torch.tools.update_readme_perf\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'dustraytracer_tpu' or m.startswith('dustraytracer_tpu.')"
        " or m == 'bench_scenes']"
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


@pytest.mark.parametrize("flag", [["--devices", "2"]])
def test_cli_not_ported_flags_raise(glb, tmp_path, flag):
    """Refused while it was not ported; now `--devices 2` splits every
    sample over two tiles on the CPU and writes the single-device image,
    byte for byte."""
    common = ["--scene", glb, "--size", "24x16", "--spp", "2", "--bounces",
              "2", "--camera-pos", "0,0,14", "--look-at", "0,0,0",
              "--device", "cpu"]
    one = _cli(*common, "--out", tmp_path / "one.png")
    tiled = _cli(*common, "--out", tmp_path / "tiled.png", *flag)
    assert one.returncode == 0, one.stderr
    assert tiled.returncode == 0, tiled.stderr
    assert json.loads(one.stdout)["devices"] == 1
    assert json.loads(tiled.stdout)["devices"] == 2
    assert json.loads(tiled.stdout)["spp"] == 2
    assert (tmp_path / "tiled.png").read_bytes() == \
        (tmp_path / "one.png").read_bytes()


def _jax_film(glb, spp, **kw):
    """The JAX package's progressive film of the same .glb and camera."""
    from dustraytracer_tpu.render.film import render_progressive
    from dustraytracer_tpu.scene import load_scene, make_camera
    from dustraytracer_tpu.scene.settings import RenderSettings

    return render_progressive(
        load_scene(str(glb)),
        make_camera(position=(0, 0, 14), look_at=(0, 0, 0), vfov_deg=60.0),
        RenderSettings(bounces=2, **kw), width=24, height=16, spp=spp)


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.int16)[::-1]


def test_cli_debug_view_matches_jax(glb, tmp_path):
    from dustraytracer_tpu.render.film import film_image
    from dustraytracer_tpu.scene.settings import DebugMode, RenderMode
    from dustraytracer_tpu_torch.utils.image import to_uint8

    out = tmp_path / "normal.png"
    proc = _cli("--scene", glb, "--size", "24x16", "--spp", "1",
                "--bounces", "2", "--camera-pos", "0,0,14", "--look-at",
                "0,0,0", "--device", "cpu", "--debug-view", "normal",
                "--out", out)
    assert proc.returncode == 0, proc.stderr
    j = film_image(_jax_film(glb, 1, render_mode=RenderMode.DEBUG,
                             debug_mode=DebugMode.NORMAL))
    want = to_uint8(np.asarray(j, np.float32)).astype(np.int16)
    # 8-bit: a value on a rounding boundary may land one step apart
    assert (np.abs(_png(out) - want).max(axis=-1) <= 1).mean() >= 0.999
    assert len(np.unique(_png(out).reshape(-1, 3), axis=0)) > 3


def test_cli_checkpoint_resumes_and_saves(glb, tmp_path):
    from dustraytracer_tpu_torch.utils.checkpoint import load_film

    ckpt = tmp_path / "film.npz"
    args = ["--scene", glb, "--size", "24x16", "--bounces", "2",
            "--camera-pos", "0,0,14", "--look-at", "0,0,0", "--device",
            "cpu", "--checkpoint", ckpt, "--out", tmp_path / "x.png"]
    first = _cli(*args, "--spp", "2")
    assert first.returncode == 0, first.stderr
    assert load_film(ckpt, 24, 16).frame == 2
    second = _cli(*args, "--spp", "3")
    assert second.returncode == 0, second.stderr
    assert "resumed from" in second.stderr and "at sample 2" in second.stderr
    assert json.loads(second.stdout)["spp"] == 1
    film = load_film(ckpt, 24, 16)
    j = _jax_film(glb, 3)
    assert film.frame == int(j.frame) == 3
    np.testing.assert_allclose(film.accum.numpy() / 3,
                               np.asarray(j.accum) / 3, atol=2e-3)


def test_cli_stats_matches_jax(glb):
    from dustraytracer_tpu.scene import load_scene

    proc = subprocess.run(
        [sys.executable, "-m", "dustraytracer_tpu_torch.apps.cli", "stats",
         "--scene", str(glb)], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout)
    assert got.pop("ingest_seconds") >= 0.0
    assert got == load_scene(str(glb)).stats
