"""Minimal glTF 2.0 reader (.glb and .gltf) producing flat numpy arrays.

Port of dustraytracer_tpu/scene/gltf.py, unchanged in behaviour: the
same documents come out of the same files (tests/test_torch_gltf.py).
It needs only `json`, `struct` and numpy; Pillow is imported inside the
image decoder alone, so a file with no images loads where Pillow is
absent.
"""

from __future__ import annotations

import base64
import io
import json
import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}

_TYPE_COUNTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT2": 4,
    "MAT3": 9,
    "MAT4": 16,
}

GLB_MAGIC = 0x46546C67  # "glTF"


@dataclass
class GltfPrimitive:
    """One triangle primitive, indices already expanded, transforms applied."""

    positions: np.ndarray  # (n_tri, 3, 3) float32, world space
    normals: np.ndarray  # (n_tri, 3, 3) float32, world space (normalized)
    uvs: np.ndarray  # (n_tri, 3, 2) float32
    material: int  # material index, -1 if none


@dataclass
class GltfMaterial:
    """PBR metallic-roughness subset, matching what the reference parses
    (`Scene.cu:59-86`): baseColorFactor, metallicFactor, roughnessFactor,
    emissiveFactor, baseColorTexture.index."""

    name: str = ""
    base_color: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    metallic: float = 0.0
    roughness: float = 1.0
    emissive: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    base_color_texture: int = -1
    emissive_texture: int = -1
    metallic_roughness_texture: int = -1
    normal_texture: int = -1
    alpha_mode: str = "OPAQUE"  # OPAQUE | MASK | BLEND
    alpha_cutoff: float = 0.5
    double_sided: bool = False
    # Glass: the reference's Material POD carries Transmission and
    # refractive_index (`Material.cuh:10-22`) and Random.cu declares
    # refract/reflectance helpers "for future glass", but the integrator
    # never implemented it (`TraceRay.cu:34` "does not support glass
    # material"). We parse the standard glTF sources for the same two
    # quantities — KHR_materials_transmission / KHR_materials_ior — and
    # DO shade them (integrator pbr mode).
    transmission: float = 0.0
    ior: float = 1.5


@dataclass
class GltfDocument:
    """Parsed scene content: triangle primitives grouped by mesh instance."""

    meshes: list  # list[(name, list[GltfPrimitive])]
    materials: list  # list[GltfMaterial]
    images: list  # list[np.ndarray (H, W, 4) uint8]
    cameras: list  # list[dict] raw glTF camera defs with world transform

    @property
    def primitives(self):
        out = []
        for _, prims in self.meshes:
            out.extend(prims)
        return out

    @property
    def triangle_count(self):
        return sum(p.positions.shape[0] for p in self.primitives)


def _read_glb(data: bytes):
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != GLB_MAGIC:
        raise ValueError("not a GLB file (bad magic)")
    if version != 2:
        raise ValueError(f"unsupported GLB version {version}")
    offset = 12
    gltf_json = None
    bin_chunk = None
    while offset < len(data):
        chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
        offset += 8
        chunk = data[offset : offset + chunk_len]
        offset += chunk_len
        if chunk_type == 0x4E4F534A:  # "JSON"
            gltf_json = json.loads(chunk)
        elif chunk_type == 0x004E4942:  # "BIN\0"
            bin_chunk = chunk
    if gltf_json is None:
        raise ValueError("GLB missing JSON chunk")
    return gltf_json, bin_chunk


def _resolve_buffer(buf: dict, base_dir: Path, bin_chunk):
    uri = buf.get("uri")
    if uri is None:
        if bin_chunk is None:
            raise ValueError("buffer without uri and no GLB BIN chunk")
        return bin_chunk
    if uri.startswith("data:"):
        b64 = uri.split(",", 1)[1]
        return base64.b64decode(b64)
    return (base_dir / uri).read_bytes()


class _Reader:
    def __init__(self, gltf: dict, buffers):
        self.gltf = gltf
        self.buffers = buffers

    def accessor(self, idx: int) -> np.ndarray:
        acc = self.gltf["accessors"][idx]
        count = acc["count"]
        n_comp = _TYPE_COUNTS[acc["type"]]
        dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]])
        if "bufferView" not in acc:
            arr = np.zeros((count, n_comp) if n_comp > 1 else (count,),
                           dtype)
        else:
            bv = self.gltf["bufferViews"][acc["bufferView"]]
            buf = self.buffers[bv["buffer"]]
            start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
            stride = bv.get("byteStride") or dtype.itemsize * n_comp
            elem_bytes = dtype.itemsize * n_comp
            if stride == elem_bytes:
                arr = np.frombuffer(buf, dtype, count * n_comp, start)
            else:
                # strided: gather each element
                raw = np.frombuffer(buf, np.uint8)
                idxs = start + stride * np.arange(count)[:, None] \
                    + np.arange(elem_bytes)[None, :]
                arr = raw[idxs].copy().view(dtype)
            arr = (arr.reshape(count, n_comp) if n_comp > 1
                   else arr.reshape(count))
        if "sparse" in acc:
            # base + sparse overlay (glTF 2.0 §3.6.2.4; tinygltf handles
            # this transparently for the reference, Scene.cu:22-57):
            # `indices` selects rows of the base array, `values` replaces
            # them. The base may be a zero-filled bufferView-less array.
            sp = acc["sparse"]
            n_sp = sp["count"]
            idx_dt = np.dtype(_COMPONENT_DTYPES[
                sp["indices"]["componentType"]])
            rows = self._sparse_block(sp["indices"], n_sp, 1, idx_dt)
            vals = self._sparse_block(sp["values"], n_sp, n_comp, dtype)
            arr = arr.copy()
            arr[rows.astype(np.int64)] = (
                vals if n_comp > 1 else vals.reshape(n_sp))
        return arr

    def _sparse_block(self, block: dict, count: int, n_comp: int,
                      dtype: np.dtype) -> np.ndarray:
        """Read a sparse indices/values block: a bufferView + byteOffset
        pair holding `count` tightly-packed elements."""
        bv = self.gltf["bufferViews"][block["bufferView"]]
        buf = self.buffers[bv["buffer"]]
        start = bv.get("byteOffset", 0) + block.get("byteOffset", 0)
        arr = np.frombuffer(buf, dtype, count * n_comp, start)
        return arr.reshape(count, n_comp) if n_comp > 1 else arr

    def image(self, idx: int) -> np.ndarray:
        from PIL import Image

        img = self.gltf["images"][idx]
        if "bufferView" in img:
            bv = self.gltf["bufferViews"][img["bufferView"]]
            buf = self.buffers[bv["buffer"]]
            start = bv.get("byteOffset", 0)
            data = bytes(buf[start : start + bv["byteLength"]])
        elif "uri" in img:
            uri = img["uri"]
            if uri.startswith("data:"):
                data = base64.b64decode(uri.split(",", 1)[1])
            else:
                data = (self.base_dir / uri).read_bytes()
        else:
            raise ValueError("image without bufferView or uri")
        pil = Image.open(io.BytesIO(data)).convert("RGBA")
        return np.asarray(pil, dtype=np.uint8)


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.array(node["matrix"], np.float64).reshape(4, 4).T  # column-major in glTF
    m = np.eye(4)
    if "scale" in node:
        m = m @ np.diag([*node["scale"], 1.0])
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ]
        )
        rm = np.eye(4)
        rm[:3, :3] = r
        m = rm @ m
    if "translation" in node:
        tm = np.eye(4)
        tm[:3, 3] = node["translation"]
        m = tm @ m
    return m


def _parse_material(mat: dict) -> GltfMaterial:
    pbr = mat.get("pbrMetallicRoughness", {})
    base = np.array(pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32)[:3]
    ext = mat.get("extensions", {})

    def tex_index(d, key):
        t = d.get(key)
        return t["index"] if t is not None else -1

    return GltfMaterial(
        transmission=float(ext.get("KHR_materials_transmission", {})
                           .get("transmissionFactor", 0.0)),
        ior=float(ext.get("KHR_materials_ior", {}).get("ior", 1.5)),
        name=mat.get("name", ""),
        base_color=base,
        metallic=float(pbr.get("metallicFactor", 1.0)),
        roughness=float(pbr.get("roughnessFactor", 1.0)),
        emissive=np.array(mat.get("emissiveFactor", [0, 0, 0]), np.float32),
        base_color_texture=tex_index(pbr, "baseColorTexture"),
        metallic_roughness_texture=tex_index(pbr, "metallicRoughnessTexture"),
        emissive_texture=tex_index(mat, "emissiveTexture"),
        normal_texture=tex_index(mat, "normalTexture"),
        alpha_mode=mat.get("alphaMode", "OPAQUE"),
        alpha_cutoff=float(mat.get("alphaCutoff", 0.5)),
        double_sided=bool(mat.get("doubleSided", False)),
    )


def load_gltf(path) -> GltfDocument:
    """Load a .glb or .gltf file into a GltfDocument of flat numpy arrays.

    Triangles come out with indices expanded into per-corner arrays (the
    reference's data model: a flat AoS triangle soup, `Scene.cu:161-178`;
    ours is SoA) and node-hierarchy world transforms applied.
    """
    path = Path(path)
    raw = path.read_bytes()
    if raw[:4] == b"glTF":
        gltf, bin_chunk = _read_glb(raw)
    else:
        gltf = json.loads(raw)
        bin_chunk = None
    base_dir = path.parent
    buffers = [_resolve_buffer(b, base_dir, bin_chunk) for b in gltf.get("buffers", [])]
    reader = _Reader(gltf, buffers)
    reader.base_dir = base_dir

    materials = [_parse_material(m) for m in gltf.get("materials", [])]

    # glTF textures indirect: texture -> image (source). The reference indexes
    # textures directly by image order; we resolve texture->image so material
    # texture indices address the decoded image list.
    images = [reader.image(i) for i in range(len(gltf.get("images", [])))]
    tex_to_img = [t.get("source", -1) for t in gltf.get("textures", [])]
    for m in materials:
        for attr in ("base_color_texture", "emissive_texture",
                     "metallic_roughness_texture", "normal_texture"):
            t = getattr(m, attr)
            setattr(m, attr, tex_to_img[t] if 0 <= t < len(tex_to_img) else -1)

    # Walk the node hierarchy of the default scene, accumulating transforms.
    scene_idx = gltf.get("scene", 0)
    scenes = gltf.get("scenes", [{}])
    root_nodes = scenes[scene_idx].get("nodes", []) if scenes else []
    nodes = gltf.get("nodes", [])

    meshes_out = []
    cameras_out = []

    def visit(node_idx: int, parent_m: np.ndarray):
        node = nodes[node_idx]
        world = parent_m @ _node_matrix(node)
        if "mesh" in node:
            mesh = gltf["meshes"][node["mesh"]]
            prims = []
            for prim in mesh.get("primitives", []):
                p = _load_primitive(reader, prim, world)
                if p is not None:
                    prims.append(p)
            meshes_out.append((mesh.get("name", f"mesh{node['mesh']}"), prims))
        if "camera" in node:
            cam = dict(gltf["cameras"][node["camera"]])
            cam["world"] = world
            cameras_out.append(cam)
        for child in node.get("children", []):
            visit(child, world)

    for n in root_nodes:
        visit(n, np.eye(4))
    if not root_nodes:  # no scene graph: load all meshes untransformed
        for mi, mesh in enumerate(gltf.get("meshes", [])):
            prims = []
            for prim in mesh.get("primitives", []):
                p = _load_primitive(reader, prim, np.eye(4))
                if p is not None:
                    prims.append(p)
            meshes_out.append((mesh.get("name", f"mesh{mi}"), prims))

    return GltfDocument(meshes=meshes_out, materials=materials, images=images,
                        cameras=cameras_out)


def _load_primitive(reader: _Reader, prim: dict, world: np.ndarray):
    mode = prim.get("mode", 4)
    if mode != 4:  # only TRIANGLES
        return None
    attrs = prim["attributes"]
    pos = reader.accessor(attrs["POSITION"]).astype(np.float32)
    n_verts = pos.shape[0]
    if "NORMAL" in attrs:
        nrm = reader.accessor(attrs["NORMAL"]).astype(np.float32)
    else:
        nrm = np.zeros_like(pos)
    if "TEXCOORD_0" in attrs:
        uv = reader.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
    else:
        uv = np.zeros((n_verts, 2), np.float32)

    if "indices" in prim:
        idx = reader.accessor(prim["indices"]).astype(np.int64)
    else:
        idx = np.arange(n_verts, dtype=np.int64)
    idx = idx.reshape(-1, 3)

    # world transform (positions: affine; normals: inverse-transpose)
    m3 = world[:3, :3]
    pos_w = pos @ m3.T + world[:3, 3]
    nrm_m = np.linalg.inv(m3).T if abs(np.linalg.det(m3)) > 1e-12 else m3
    nrm_w = nrm @ nrm_m.T
    norms = np.linalg.norm(nrm_w, axis=-1, keepdims=True)
    nrm_w = nrm_w / np.maximum(norms, 1e-20)

    return GltfPrimitive(
        positions=pos_w[idx].astype(np.float32),  # (n_tri, 3, 3)
        normals=nrm_w[idx].astype(np.float32),
        uvs=uv[idx].astype(np.float32),
        material=prim.get("material", -1),
    )
