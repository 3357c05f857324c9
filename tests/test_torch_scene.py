"""Port ingest (dustraytracer_tpu_torch.scene.build_scene) against the JAX
package: every table equal, array for array, and the interop bridge."""

import dataclasses

import numpy as np
import pytest
import torch

from dustraytracer_tpu.scene.gltf import GltfDocument, GltfMaterial
from dustraytracer_tpu.scene.scene import build_scene as j_build
from dustraytracer_tpu_torch import interop
from dustraytracer_tpu_torch.scene.scene import build_scene as t_build
from tests.util_scenes import make_quad, make_random_tri_doc


def _tri_doc():
    """The document behind tests/util_scenes.make_tri_scene."""
    return GltfDocument(
        meshes=[("ground", [make_quad((0, 0, 0), 10, axis=1, mat=0)]),
                ("wall", [make_quad((0, 1, -2), 2, axis=2, mat=1)])],
        materials=[GltfMaterial(base_color=np.float32([0.8, 0.8, 0.8])),
                   GltfMaterial(base_color=np.float32([0.9, 0.2, 0.2]))],
        images=[], cameras=[])


def _textured_doc():
    doc = make_random_tri_doc(90, seed=4)
    img = np.random.default_rng(5).integers(0, 256, (6, 5, 4), np.uint8)
    img[0, 0, 3] = 17  # one translucent texel
    doc.materials[0].base_color_texture = 0
    return dataclasses.replace(doc, images=[img])


DOCS = {"tri_scene": _tri_doc,
        "random_700": lambda: make_random_tri_doc(700),
        "textured": _textured_doc}


def _assert_leaves_equal(a: dict, b: dict, path=""):
    assert a.keys() == b.keys(), (path, a.keys() ^ b.keys())
    for key in a:
        va, vb = a[key], b[key]
        where = f"{path}{key}"
        if isinstance(va, dict) or isinstance(vb, dict):
            _assert_leaves_equal(va, vb, where + ".")
        elif isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            assert va.dtype == vb.dtype, (where, va.dtype, vb.dtype)
            np.testing.assert_array_equal(va, vb, err_msg=where)
        else:
            assert va == vb, (where, va, vb)


@pytest.mark.parametrize("name", sorted(DOCS))
def test_build_scene_equals_jax(name):
    doc = DOCS[name]()
    # exact equality: both run the same numpy host build
    _assert_leaves_equal(interop.scene_to_numpy(j_build(doc,
                                                        use_native=False)),
                         interop.scene_to_numpy(t_build(doc,
                                                        use_native=False)))


def test_interop_round_trips_jax_scene():
    js = j_build(make_random_tri_doc(300, seed=3), use_native=False)
    leaves = interop.scene_to_numpy(js)
    ts = interop.scene_from_numpy(leaves)
    assert isinstance(ts.tri_pos, torch.Tensor)
    assert ts.cluster.oct_skip.dtype == torch.int32
    assert ts.tex_stack.dtype == torch.uint8
    _assert_leaves_equal(leaves, interop.scene_to_numpy(ts))


def test_native_builder_not_ported():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        t_build(make_random_tri_doc(20), use_native=True)
