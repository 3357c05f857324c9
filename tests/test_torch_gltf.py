"""Port glTF reader (dustraytracer_tpu_torch.scene.gltf) against the JAX
package on a .glb written here with numpy + struct."""

import json
import struct
import sys

import numpy as np
import pytest

from dustraytracer_tpu.scene.gltf import load_gltf as j_load
from dustraytracer_tpu_torch.scene.gltf import load_gltf as t_load


def _write_glb(path, node):
    """A 4-vertex quad plus one extra triangle: positions, normals, uvs,
    u16 indices, one material, one node carrying `node`'s transform."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
    nrm = rng.normal(size=(5, 3)).astype(np.float32)
    uv = rng.uniform(0, 1, (5, 2)).astype(np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3, 1, 4, 2], np.uint16)
    parts = [pos.tobytes(), nrm.tobytes(), uv.tobytes(), idx.tobytes()]
    views, blob = [], b""
    for p in parts:
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": len(p)})
        blob += p + b"\0" * ((-len(p)) % 4)
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [dict(node, mesh=0, name="n0")],
        "meshes": [{"name": "m0", "primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
            "indices": 3, "material": 0}]}],
        "materials": [{"name": "mat0", "pbrMetallicRoughness": {
            "baseColorFactor": [0.2, 0.5, 0.7, 1.0], "metallicFactor": 0.3,
            "roughnessFactor": 0.6}, "emissiveFactor": [0.1, 0.0, 0.2],
            "doubleSided": True}],
        "buffers": [{"byteLength": len(blob)}],
        "bufferViews": views,
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 5,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 5,
             "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": 5,
             "type": "VEC2"},
            {"bufferView": 3, "componentType": 5123, "count": 9,
             "type": "SCALAR"}],
    }
    js = json.dumps(gltf).encode()
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(blob)
    path.write_bytes(struct.pack("<III", 0x46546C67, 2, total)
                     + struct.pack("<II", len(js), 0x4E4F534A) + js
                     + struct.pack("<II", len(blob), 0x004E4942) + blob)


NODES = {
    "trs": {"translation": [0.5, -1.0, 2.0],
            "rotation": [0.0, 0.38268343, 0.0, 0.92387953],
            "scale": [1.5, 0.5, 2.0]},
    "matrix": {"matrix": [2, 0, 0, 0, 0, 0, 1, 0, 0, -1, 0, 0,
                          0.1, 0.2, 0.3, 1]},
}


def _doc_equal(a, b):
    assert [n for n, _ in a.meshes] == [n for n, _ in b.meshes]
    for (_, pa), (_, pb) in zip(a.meshes, b.meshes):
        assert len(pa) == len(pb)
        for x, y in zip(pa, pb):
            for f in ("positions", "normals", "uvs"):
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
            assert x.material == y.material
    assert len(a.materials) == len(b.materials)
    for x, y in zip(a.materials, b.materials):
        for f in vars(x):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    assert len(a.images) == len(b.images) == 0
    assert a.cameras == b.cameras


@pytest.mark.parametrize("form", sorted(NODES))
def test_load_glb_equals_jax(tmp_path, form):
    p = tmp_path / "probe.glb"
    _write_glb(p, NODES[form])
    # the same numpy reader: documents equal exactly
    jd, td = j_load(p), t_load(p)
    assert td.triangle_count == 3
    _doc_equal(jd, td)


def test_load_without_pillow(tmp_path, monkeypatch):
    p = tmp_path / "probe.glb"
    _write_glb(p, NODES["trs"])
    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL now fails
    assert t_load(p).triangle_count == 3
