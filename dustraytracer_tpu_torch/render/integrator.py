"""The path integrator over ray batches, forward NORMAL mode (port of
render/integrator.py).

One sample for N pixels is a wavefront: camera rays, then `bounces`
path segments, each of which traces closest hits, adds sky on a miss,
multiplies the throughput by the (textured) albedo, adds the sun through
an any-hit shadow ray, and bounces diffusely; finally tonemap and gamma.
Traversal goes through ops/traverse_sweep.py (the CUDA kernel on a card,
its twin on the CPU), with rays sorted by (direction octant, origin
Morton) first. Shading recomputes the hit attributes from the hit ids
with plain gathers.

Options the port does not run yet raise NotImplementedError: the debug
views, shading="pbr", shade_fetch="kernel", soft_edges, alpha_test, and
the brute-force, gather-walk and XLA-cluster traversals.
"""

from __future__ import annotations

import torch

from dustraytracer_tpu_torch.ops.intersect import moller_trumbore
from dustraytracer_tpu_torch.ops.rng import (random_float, random_in_ball,
                                             random_unit_vec3, seed_pixels)
from dustraytracer_tpu_torch.ops.tonemap import (gamma_correct,
                                                 uncharted2_filmic)
from dustraytracer_tpu_torch.ops.traverse_sweep import traverse_cluster_sweep
from dustraytracer_tpu_torch.render.texture import sample_texture
from dustraytracer_tpu_torch.scene.camera import Camera, generate_rays
from dustraytracer_tpu_torch.scene.settings import (LightParams, RenderMode,
                                                    RenderSettings)

_PARK = 3.0e37  # origin of dead lanes: their walk ends at the root


def _not_ported(what: str):
    return NotImplementedError(f"{what} not yet ported, see ROADMAP.md")


def _check_settings(settings: RenderSettings):
    if settings.render_mode == RenderMode.DEBUG:
        raise _not_ported("render_mode=DEBUG (debug views)")
    if settings.shading != "reference":
        raise _not_ported(f"shading={settings.shading!r}")
    if settings.shade_fetch == "kernel":
        raise _not_ported("shade_fetch='kernel'")
    if settings.soft_edges > 0.0:
        raise _not_ported("soft_edges")
    if settings.alpha_test:
        raise _not_ported("alpha_test")


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _fetch_material(scene, mats: torch.Tensor) -> dict:
    """Per-ray material attributes, one packed row gather."""
    tab = torch.cat(
        [scene.mat_albedo, scene.mat_emissive,
         scene.mat_metallic[:, None], scene.mat_roughness[:, None],
         scene.mat_albedo_tex.to(torch.float32)[:, None],
         scene.mat_transmission[:, None], scene.mat_ior[:, None]], dim=1)
    rows = tab[mats.to(torch.int64)]
    return {"albedo": rows[:, 0:3], "emissive": rows[:, 3:6],
            "metallic": rows[:, 6], "roughness": rows[:, 7],
            "tex": rows[:, 8].to(torch.int32),
            "transmission": rows[:, 9], "ior": rows[:, 10]}


def shade_hits(scene, origin, direction, hit_idx, smooth: bool = False):
    """Hit attributes recomputed from discrete hit ids with one packed
    row gather per ray: world position, viewer-facing normal (geometric,
    or interpolated vertex normals with smooth=True), uv, barycentrics,
    material id, front_face. Miss lanes get finite placeholder values."""
    safe = torch.clamp_min(hit_idx, 0).to(torch.int64)
    t_n = scene.tri_pos.shape[0]
    cols = [scene.tri_pos.reshape(t_n, 9), scene.tri_face_nrm,
            scene.tri_uv.reshape(t_n, 6),
            scene.tri_mat.to(torch.float32)[:, None]]
    if smooth:
        cols.append(scene.tri_nrm.reshape(t_n, 9))
    rows = torch.cat(cols, dim=1)[safe]
    v0, v1, v2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    face_nrm = rows[:, 9:12]
    uv0, uv1, uv2 = rows[:, 12:14], rows[:, 14:16], rows[:, 16:18]
    mat = rows[:, 18].to(torch.int32)
    _valid, t, u, v = moller_trumbore(origin, direction, v0, v1, v2)
    ok = hit_idx >= 0
    t = torch.where(ok, t, 1.0)
    u = torch.where(ok, u, 0.3)
    v = torch.where(ok, v, 0.3)
    w = 1.0 - u - v

    world_pos = origin + direction * t[:, None]
    raw_n = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    raw_n = raw_n / torch.clamp_min(_norm(raw_n), 1e-20)
    orient = (raw_n * face_nrm).sum(dim=-1)
    face_n = raw_n * torch.sign(orient)[:, None]
    d_norm = direction / _norm(direction)
    front = (face_n * d_norm).sum(dim=-1) <= 0.0
    normal = torch.where(front[:, None], face_n, -face_n)
    if smooth:
        corner = rows[:, 19:28].reshape(-1, 3, 3)
        sm = (w[:, None] * corner[:, 0] + u[:, None] * corner[:, 1]
              + v[:, None] * corner[:, 2])
        ln = _norm(sm)
        sm = torch.where(ln > 1e-8, sm / torch.clamp_min(ln, 1e-20), normal)
        flip = (sm * d_norm).sum(dim=-1) > 0.0
        normal = torch.where(flip[:, None], -sm, sm)

    uv = w[:, None] * uv0 + u[:, None] * uv1 + v[:, None] * uv2
    return {"t": t, "bary": torch.stack([w, u, v], dim=-1),
            "world_position": world_pos, "normal": normal, "uv": uv,
            "material": mat, "front_face": front}


def _sky(direction, lights: LightParams):
    """Gradient sky: lerp(white, sky_color) by 0.5 * (1 + dir.y), squared."""
    d = direction / _norm(direction)
    g = 0.5 * (1.0 + d[:, 1])
    ones = torch.ones(3, dtype=torch.float32, device=direction.device)
    col = (1.0 - g)[:, None] * ones + g[:, None] * lights.sky_color
    return col * col


def _albedo(scene, mat_attrs, uv, bilinear=False):
    tex = mat_attrs["tex"]
    sampled = sample_texture(scene, tex, uv, bilinear=bilinear)
    return torch.where((tex >= 0)[:, None], sampled, mat_attrs["albedo"])


def ray_sort_key(lo, hi, o, d):
    """(octant, 15-bit origin Morton) traversal-coherence key, int64."""
    inv_ext = 1.0 / torch.clamp_min(hi - lo, 1e-12)

    def _spread3(x):  # low 10 bits -> every 3rd bit
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    octant = ((d[:, 0] < 0).to(torch.int64) * 4
              + (d[:, 1] < 0).to(torch.int64) * 2
              + (d[:, 2] < 0).to(torch.int64))
    q = torch.clamp((o - lo) * inv_ext, 0.0, 1.0)
    q = (q * 31.0).to(torch.int64)
    morton = (_spread3(q[:, 0]) * 4 + _spread3(q[:, 1]) * 2
              + _spread3(q[:, 2]))
    return octant * (1 << 15) + morton


def _sorted_tracers(scene, closest, anyhit):
    """Trace rays in ray_sort_key order (argsort + gather) and scatter
    the results back to ray order, so neighbouring threads walk similar
    paths through the tree. Invisible to callers."""
    lo = scene.node_min[0]
    hi = scene.node_max[0]

    def _perm(o, d):
        return torch.argsort(ray_sort_key(lo, hi, o, d), stable=True)

    def closest_sorted(o, d):
        perm = _perm(o, d)
        r = closest(o[perm], d[perm])
        out = {}
        for key, val in r.items():
            out[key] = torch.empty_like(val)
            out[key][perm] = val
        return out

    def anyhit_sorted(o, d):
        perm = _perm(o, d)
        occ = anyhit(o[perm], d[perm])
        out = torch.empty_like(occ)
        out[perm] = occ
        return out

    return closest_sorted, anyhit_sorted


def _make_tracers(scene, settings: RenderSettings):
    """Pick the traversal backend: the sweep traversal (kernel on a
    card, twin on the CPU) for a cluster scene above brute_max_tris, or
    for any cluster scene with traversal='sweep'."""
    cb = scene.cluster
    if cb is None:
        raise _not_ported("traversal of scenes without cluster tables "
                          "(the gather walk)")
    if settings.traversal not in ("auto", "sweep"):
        raise _not_ported(f"traversal={settings.traversal!r}")
    if (settings.traversal == "auto"
            and cb.n_clusters * cb.k <= settings.brute_max_tris):
        raise _not_ported("traversal='auto' on a scene at or below "
                          "brute_max_tris (the brute-force traversal)")

    def closest(o, d):
        return traverse_cluster_sweep(cb, o, d)

    def anyhit(o, d):
        return traverse_cluster_sweep(cb, o, d, anyhit=True)["hit_idx"] >= 0

    if settings.ray_sort in ("auto", "on"):
        closest, anyhit = _sorted_tracers(scene, closest, anyhit)
    return closest, anyhit


def _segment(scene, lights: LightParams, settings: RenderSettings, tracers,
             carry, bounce_idx: int):
    """One path segment for all rays."""
    origin, direction, throughput, light, alive, rng = carry
    sun_pos = lights.sun_position()
    sun_col = lights.sun_color * lights.sun_intensity
    trace_closest, trace_anyhit = tracers

    o_live = torch.where(alive[:, None], origin, _PARK)
    res = trace_closest(o_live, direction)
    hit_idx = torch.where(alive, res["hit_idx"], -1)
    miss = hit_idx < 0
    live_hit = alive & ~miss

    # sky on miss
    sky = _sky(direction, lights)
    light = light + torch.where((alive & miss)[:, None],
                                throughput * sky * lights.sky_intensity, 0.0)

    sh = shade_hits(scene, origin, direction, hit_idx,
                    smooth=settings.smooth_shading)
    matd = _fetch_material(scene, sh["material"])
    alb = _albedo(scene, matd, sh["uv"],
                  bilinear=settings.tex_filter == "bilinear")
    throughput = torch.where(live_hit[:, None], throughput * alb, throughput)
    new_origin = sh["world_position"] + sh["normal"] * 1e-3

    # sun NEE shadow ray
    if settings.enable_sunlight:
        rng, jit_vec = random_unit_vec3(rng)
        shadow_dir = sun_pos[None, :] + jit_vec * 1.5
        nee_o = torch.where(live_hit[:, None], new_origin, _PARK)
        occluded = trace_anyhit(nee_o, shadow_dir)
        contrib = sun_col[None, :] * throughput
        if settings.nee_cosine:
            d_n = shadow_dir / _norm(shadow_dir)
            contrib = contrib * torch.clamp_min(
                (sh["normal"] * d_n).sum(dim=-1), 0.0)[:, None]
        light = light + torch.where((live_hit & ~occluded)[:, None],
                                    contrib, 0.0)

    # russian roulette
    if settings.russian_roulette:
        rng, u_rr = random_float(rng)
        p = torch.clamp(throughput.amax(dim=-1), 0.05, 1.0)
        if bounce_idx >= settings.rr_start_bounce:
            survive = u_rr < p
            throughput = throughput * torch.where(survive, 1.0 / p,
                                                  1.0)[:, None]
        else:
            survive = torch.ones_like(live_hit)
        alive = live_hit & survive
    else:
        alive = live_hit

    # diffuse bounce: normal + in-ball sample (or cosine-weighted)
    rng, ball = random_in_ball(rng)
    bounce_dir = sh["normal"] + ball
    if settings.cosine_weighted:
        rng, sph = random_unit_vec3(rng)
        bounce_dir = sh["normal"] + sph
        bounce_dir = bounce_dir / torch.clamp_min(_norm(bounce_dir), 1e-8)

    return new_origin, bounce_dir, throughput, light, alive, rng


@torch.no_grad()
def render_pixels(scene, camera: Camera, lights: LightParams, frame_idx: int,
                  pixel_ids: torch.Tensor, *, width: int, height: int,
                  settings: RenderSettings) -> torch.Tensor:
    """Render one sample for a flat batch of pixel ids -> (N, 3) colour,
    on the scene's device."""
    _check_settings(settings)
    n = pixel_ids.shape[0]
    dev = pixel_ids.device
    rng = seed_pixels(pixel_ids, frame_idx)
    rng, origin, direction = generate_rays(camera, width, height, rng,
                                           pixel_ids=pixel_ids)
    carry = (origin, direction,
             torch.ones((n, 3), dtype=torch.float32, device=dev),
             torch.zeros((n, 3), dtype=torch.float32, device=dev),
             torch.ones((n,), dtype=torch.bool, device=dev), rng)
    tracers = _make_tracers(scene, settings)
    for bounce_idx in range(settings.bounces):
        carry = _segment(scene, lights, settings, tracers, carry, bounce_idx)
    color = carry[3]
    if settings.enable_tonemap:
        color = uncharted2_filmic(color, camera.exposure)
    if settings.enable_gamma:
        color = gamma_correct(color)
    return color


def render_sample(scene, camera: Camera, lights: LightParams, frame_idx: int,
                  *, width: int, height: int,
                  settings: RenderSettings) -> torch.Tensor:
    """Render one sample per pixel -> (H, W, 3) post-processed colour;
    `frame_idx` decorrelates the RNG across progressive samples."""
    pixel_ids = torch.arange(width * height, dtype=torch.int64,
                             device=scene.device)
    color = render_pixels(scene, camera, lights, frame_idx, pixel_ids,
                          width=width, height=height, settings=settings)
    return color.reshape(height, width, 3)
