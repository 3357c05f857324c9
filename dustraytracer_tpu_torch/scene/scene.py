"""Scene data model: flat SoA tensors with fixed padding (port of
scene/scene.py).

`build_scene` flattens a glTF document exactly as the JAX package does:
the same SAH permutation, the same padding (P = ((n + MAX_LEAF + 7) //
8) * 8 triangles, cluster and octant tables padded to 128 rows), so each
table equals its JAX counterpart array for array. Tensors are built on
the CPU; `Scene.to(device)` moves the scene to a card.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from dustraytracer_tpu_torch.accel.cluster import ClusterBvh
from dustraytracer_tpu_torch.scene.gltf import GltfDocument, load_gltf

MAX_LEAF = 8


def _pad_to(arr: np.ndarray, n: int, fill=0.0) -> np.ndarray:
    if arr.shape[0] >= n:
        return arr[:n]
    pad = np.full((n - arr.shape[0],) + arr.shape[1:], fill, arr.dtype)
    return np.concatenate([arr, pad], axis=0)


@dataclass
class Scene:
    """Flat scene on one device. All tensors are padded to fixed sizes."""

    # triangles (P = padded count)
    tri_pos: torch.Tensor       # (P, 3, 3) f32 corner positions
    tri_nrm: torch.Tensor       # (P, 3, 3) f32 corner shading normals
    tri_uv: torch.Tensor        # (P, 3, 2) f32 corner UVs
    tri_face_nrm: torch.Tensor  # (P, 3) f32 oriented geometric normal
    tri_mat: torch.Tensor       # (P,) i32 material index
    # threaded BVH (M = padded node count, pre-order with skip links)
    node_min: torch.Tensor      # (M, 3) f32
    node_max: torch.Tensor      # (M, 3) f32
    node_left: torch.Tensor     # (M,) i32
    node_right: torch.Tensor    # (M,) i32
    node_first: torch.Tensor    # (M,) i32
    node_count: torch.Tensor    # (M,) i32 (0 = internal)
    node_skip: torch.Tensor     # (M,) i32 (-1 = done)
    # materials (K entries)
    mat_albedo: torch.Tensor        # (K, 3) f32
    mat_emissive: torch.Tensor      # (K, 3) f32
    mat_metallic: torch.Tensor      # (K,) f32
    mat_roughness: torch.Tensor     # (K,) f32
    mat_albedo_tex: torch.Tensor    # (K,) i32 texture index or -1
    mat_transmission: torch.Tensor  # (K,) f32
    mat_ior: torch.Tensor           # (K,) f32
    # textures: (T, H, W, 4) u8 stack with per-texture true dims
    tex_stack: torch.Tensor     # (T, H, W, 4) u8
    tex_hw: torch.Tensor        # (T, 2) i32 (height, width)
    tex_has_alpha: torch.Tensor  # (T,) bool
    cluster: ClusterBvh | None = None
    bvh_range_a: torch.Tensor | None = None  # (n_nodes,) i32
    bvh_range_b: torch.Tensor | None = None  # (n_nodes,) i32
    bvh_levels: int = 0
    n_tris: int = 0
    n_nodes: int = 0
    n_materials: int = 0
    n_textures: int = 0
    bvh_depth: int = 0
    mesh_names: tuple = ()
    mesh_tri_counts: tuple = ()

    def to(self, device) -> "Scene":
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        if self.cluster is not None:
            moved["cluster"] = self.cluster.to(device)
        return dataclasses.replace(self, **moved)

    def replace(self, **kw) -> "Scene":
        """dataclasses.replace, with one guard: a new `tri_pos` re-bakes
        the cluster tables (a new ClusterBvh, so no kernel table packed
        from the old vertices is reused) unless `cluster` is passed too,
        and refits the threaded BVH boxes unless `node_min` is. Raises
        when the cluster tables have no refit plan. `tri_pos` may require
        grad: shading differentiates it; the tables do not."""
        if ("tri_pos" in kw and "cluster" not in kw
                and self.cluster is not None):
            if self.cluster.refit_a is None:
                raise ValueError(
                    "replacing tri_pos on a scene whose cluster tables "
                    "have no refit plan (refit_a=None) would leave "
                    "them stale; pass cluster=... explicitly")
            from dustraytracer_tpu_torch.accel.cluster import \
                refit_cluster_bvh

            kw = dict(kw, cluster=refit_cluster_bvh(self.cluster,
                                                    kw["tri_pos"]))
        if ("tri_pos" in kw and "node_min" not in kw
                and self.bvh_range_a is not None and self.bvh_levels):
            from dustraytracer_tpu_torch.accel.bvh import refit_bvh_boxes

            nm, nx = refit_bvh_boxes(
                kw["tri_pos"], self.node_min, self.node_max,
                levels=self.bvh_levels, range_a=self.bvh_range_a,
                range_b=self.bvh_range_b, n_tris=self.n_tris,
                n_nodes=self.n_nodes)
            kw = dict(kw, node_min=nm, node_max=nx)
        return dataclasses.replace(self, **kw)

    @property
    def device(self) -> torch.device:
        return self.tri_pos.device

    @property
    def stats(self) -> dict:
        """Triangle, object, BVH, material and texture counts and the
        per-mesh triangle table (the CLI's `stats`)."""
        return {
            "triangles": self.n_tris,
            "objects": len(self.mesh_names),
            "bvh_nodes": self.n_nodes,
            "bvh_depth": self.bvh_depth,
            "materials": self.n_materials,
            "textures": self.n_textures,
            "meshes": [{"name": nm, "triangles": ct}
                       for nm, ct in zip(self.mesh_names,
                                         self.mesh_tri_counts)],
        }


def _face_normals(pos: np.ndarray, nrm: np.ndarray) -> np.ndarray:
    """cross(e1, e2) normalized, flipped to agree with the mean vertex
    normal."""
    e1 = pos[:, 1] - pos[:, 0]
    e2 = pos[:, 2] - pos[:, 0]
    fn = np.cross(e1, e2)
    ln = np.linalg.norm(fn, axis=-1, keepdims=True)
    fn = fn / np.maximum(ln, 1e-20)
    avg = nrm.mean(axis=1)
    flip = (fn * avg).sum(-1) < 0.0
    fn[flip] = -fn[flip]
    return fn.astype(np.float32)


def build_scene(doc: GltfDocument, leaf_target: int = MAX_LEAF,
                bins: int = 16, use_native: bool = False,
                cluster_k="auto") -> Scene:
    """Flatten a GltfDocument into a CPU Scene: SAH-permuted triangle
    soup, threaded BVH, cluster tables, materials, texture stack."""
    from dustraytracer_tpu_torch.accel.bvh import build_bvh, refit_plan
    from dustraytracer_tpu_torch.accel.cluster import build_cluster_bvh

    prims = doc.primitives
    if not prims:
        raise ValueError("scene has no triangle primitives")
    mesh_names = tuple(name for name, _ in doc.meshes)
    mesh_tri_counts = tuple(
        int(sum(p.positions.shape[0] for p in mesh_prims))
        for _, mesh_prims in doc.meshes)

    pos = np.concatenate([p.positions for p in prims], axis=0)
    nrm = np.concatenate([p.normals for p in prims], axis=0)
    uv = np.concatenate([p.uvs for p in prims], axis=0)
    mat = np.concatenate(
        [np.full(p.positions.shape[0], max(p.material, 0), np.int32)
         for p in prims])

    # zero vertex normals (some exports) take the raw face normal
    zero_n = np.linalg.norm(nrm.reshape(-1, 3), axis=-1) < 1e-12
    if zero_n.any():
        fn = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
        fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
        rep = np.repeat(fn[:, None, :], 3, axis=1).reshape(-1, 3)
        nrm = nrm.reshape(-1, 3)
        nrm[zero_n] = rep[zero_n]
        nrm = nrm.reshape(-1, 3, 3)

    face_nrm = _face_normals(pos, nrm)

    n_tris = pos.shape[0]
    leaf_target = min(leaf_target, MAX_LEAF)
    bvh = build_bvh(pos, leaf_target=leaf_target, bins=bins,
                    use_native=use_native)
    perm = bvh.perm
    pos, nrm, uv, mat, face_nrm = (pos[perm], nrm[perm], uv[perm], mat[perm],
                                   face_nrm[perm])

    P = ((n_tris + MAX_LEAF + 7) // 8) * 8
    pos_p = _pad_to(pos.astype(np.float32), P)
    nrm_p = _pad_to(nrm.astype(np.float32), P)
    uv_p = _pad_to(uv.astype(np.float32), P)
    mat_p = _pad_to(mat.astype(np.int32), P)
    fn_p = _pad_to(face_nrm, P)

    mats = doc.materials or []
    K = max(len(mats), 1)
    albedo = np.ones((K, 3), np.float32)
    emissive = np.zeros((K, 3), np.float32)
    metallic = np.zeros(K, np.float32)
    roughness = np.ones(K, np.float32)
    alb_tex = np.full(K, -1, np.int32)
    transmission = np.zeros(K, np.float32)
    ior = np.full(K, 1.5, np.float32)
    for i, m in enumerate(mats):
        albedo[i] = m.base_color
        emissive[i] = m.emissive
        metallic[i] = m.metallic
        roughness[i] = m.roughness
        alb_tex[i] = m.base_color_texture
        transmission[i] = m.transmission
        ior[i] = m.ior

    images = doc.images or []
    if images:
        H = max(im.shape[0] for im in images)
        W = max(im.shape[1] for im in images)
        stack = np.zeros((len(images), H, W, 4), np.uint8)
        hw = np.zeros((len(images), 2), np.int32)
        has_alpha = np.zeros(len(images), bool)
        for i, im in enumerate(images):
            stack[i, : im.shape[0], : im.shape[1]] = im
            hw[i] = (im.shape[0], im.shape[1])
            has_alpha[i] = bool((im[..., 3] < 255).any())
    else:
        stack = np.full((1, 1, 1, 4), 255, np.uint8)
        hw = np.ones((1, 2), np.int32)
        has_alpha = np.zeros(1, bool)

    if cluster_k == "auto":
        cluster_k = 32  # the JAX package's auto pick
    cluster = None
    if cluster_k:
        cluster = build_cluster_bvh(pos_p, k=cluster_k, bins=bins,
                                    uv=uv_p, face_nrm=fn_p, mat=mat_p)

    bvh_levels, range_a, range_b, plan_n = refit_plan(
        bvh.node_first, bvh.node_count, bvh.node_skip, bvh.n_nodes)
    if plan_n != n_tris:
        raise ValueError(f"refit plan covers {plan_n} triangles, "
                         f"not {n_tris}")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    return Scene(
        cluster=cluster,
        tri_pos=t(pos_p), tri_nrm=t(nrm_p), tri_uv=t(uv_p),
        tri_face_nrm=t(fn_p), tri_mat=t(mat_p),
        node_min=t(bvh.node_min), node_max=t(bvh.node_max),
        node_left=t(bvh.node_left), node_right=t(bvh.node_right),
        node_first=t(bvh.node_first), node_count=t(bvh.node_count),
        node_skip=t(bvh.node_skip),
        mat_albedo=t(albedo), mat_emissive=t(emissive),
        mat_metallic=t(metallic), mat_roughness=t(roughness),
        mat_albedo_tex=t(alb_tex), mat_transmission=t(transmission),
        mat_ior=t(ior),
        tex_stack=t(stack), tex_hw=t(hw), tex_has_alpha=t(has_alpha),
        bvh_range_a=t(range_a), bvh_range_b=t(range_b),
        bvh_levels=bvh_levels,
        n_tris=int(n_tris), n_nodes=int(bvh.n_nodes),
        n_materials=len(mats), n_textures=len(images),
        bvh_depth=int(bvh.depth),
        mesh_names=mesh_names, mesh_tri_counts=mesh_tri_counts,
    )


def load_scene(path, **kw) -> Scene:
    """One-call ingest: glTF file -> CPU Scene."""
    return build_scene(load_gltf(path), **kw)
