"""The port's CLI takes the JAX CLI's `--cpu`: `render --cpu` renders on
the CPU as `--device cpu` does (and is a usage error beside `--device
cuda`), `stats --cpu` is accepted and changes nothing. Both packages'
parsers take the same command lines, and the port's `--cpu` runs touch
no CUDA call."""

import json

import numpy as np
import pytest
import torch

from dustraytracer_tpu.apps import cli as j_cli
from dustraytracer_tpu_torch.apps import cli

RENDER = ["render", "--scene", "soup.glb", "--size", "16x12", "--spp", "1",
          "--bounces", "1", "--camera-pos", "0,0,14", "--look-at", "0,0,0",
          "--cpu", "--out", "x.png"]
STATS = ["stats", "--scene", "soup.glb", "--cpu"]


@pytest.fixture(scope="module")
def glb(tmp_path_factory):
    from chip_smoke import write_glb
    from dustraytracer_tpu_torch.scene.gltf import GltfDocument
    from tests.util_scenes import make_random_tri_doc

    doc = make_random_tri_doc(200, seed=7)
    path = tmp_path_factory.mktemp("cli_cpu") / "soup.glb"
    write_glb(path, GltfDocument(meshes=doc.meshes, materials=doc.materials,
                                 images=[], cameras=[]))
    return path


@pytest.fixture
def no_cuda(monkeypatch):
    """Every CUDA entry the port's CLI could reach raises."""
    from dustraytracer_tpu_torch.ops import cuda_build

    def touched(*_a, **_k):
        raise AssertionError("a --cpu run touched CUDA")

    for name in ("is_available", "synchronize", "Event", "current_stream",
                 "get_device_name", "device"):
        monkeypatch.setattr(torch.cuda, name, touched)
    monkeypatch.setattr(cuda_build, "load_library", touched)


@pytest.mark.parametrize("argv", [RENDER, STATS], ids=["render", "stats"])
def test_both_parsers_take_the_same_argv(argv):
    want = j_cli.build_parser().parse_args(argv)
    got = cli.build_parser().parse_args(argv)
    assert want.cpu is True and got.cpu is True
    assert got.command == want.command and got.scene == want.scene
    if argv is RENDER:
        for key in ("size", "spp", "bounces", "camera_pos", "look_at", "out"):
            assert getattr(got, key) == getattr(want, key), key
        assert cli.parse_args(argv).device == "cpu"


@pytest.mark.parametrize("extra, device", [([], "cuda"),
                                           (["--device", "cpu"], "cpu"),
                                           (["--cpu", "--device", "cpu"],
                                            "cpu")])
def test_render_device_resolves(extra, device):
    argv = [a for a in RENDER if a != "--cpu"] + extra
    assert cli.parse_args(argv).device == device


@pytest.mark.parametrize("order", ["cpu_first", "device_first"])
def test_cpu_with_device_cuda_is_a_usage_error(order, capsys):
    flags = (["--cpu", "--device", "cuda"] if order == "cpu_first"
             else ["--device", "cuda", "--cpu"])
    with pytest.raises(SystemExit) as exc:
        cli.parse_args([a for a in RENDER if a != "--cpu"] + flags)
    assert exc.value.code == 2
    assert "--cpu conflicts with --device cuda" in capsys.readouterr().err


def test_stats_cpu_matches_jax_without_cuda(glb, no_cuda, capsys):
    from dustraytracer_tpu.scene import load_scene

    assert cli.main(["stats", "--scene", str(glb), "--cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got.pop("ingest_seconds") >= 0.0
    assert got == load_scene(str(glb)).stats


def test_render_cpu_runs_without_cuda(glb, tmp_path, no_cuda, capsys):
    from dustraytracer_tpu_torch.ops import traverse_pallas as tp
    from dustraytracer_tpu_torch.ops import traverse_sweep as ts

    out = tmp_path / "cpu.png"
    argv = [str(glb) if a == "soup.glb" else str(out) if a == "x.png" else a
            for a in RENDER]
    launches = (ts.LAUNCHES, ts.EMIT_LAUNCHES, tp.LAUNCHES)
    assert cli.main(argv) == 0
    metrics = json.loads(capsys.readouterr().out)
    assert metrics["device"] == "cpu" and metrics["triangles"] == 200
    assert metrics["size"] == [16, 12] and metrics["spp"] == 1
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert (ts.LAUNCHES, ts.EMIT_LAUNCHES, tp.LAUNCHES) == launches


def test_render_cpu_equals_device_cpu(glb, tmp_path):
    imgs = []
    for flag in (["--cpu"], ["--device", "cpu"]):
        out = tmp_path / f"{flag[-1]}.png"
        argv = [a for a in RENDER if a != "--cpu"] + flag
        argv = [str(glb) if a == "soup.glb" else str(out) if a == "x.png"
                else a for a in argv]
        assert cli.main(argv) == 0
        imgs.append(np.frombuffer(out.read_bytes(), np.uint8))
    np.testing.assert_array_equal(imgs[0], imgs[1])
