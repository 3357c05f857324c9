"""The differentiable path integrator over ray batches (port of
render/integrator.py).

One NORMAL-mode sample for N pixels is a wavefront: camera rays, then
`bounces` path segments, each of which traces closest hits, adds sky on
a miss, multiplies the throughput by the (textured) albedo, adds the sun
through an any-hit shadow ray, and bounces diffusely; finally tonemap
and gamma. shading="pbr" adds emission, a metal lobe and glass
(refraction, Fresnel, frosted fuzz); soft_edges > 0 makes silhouettes
differentiable with one continuation trace per segment. DEBUG mode
traces camera rays once and returns a debug view (albedo, normal,
barycentrics, uvs or BVH visit heat).
Traversal is picked per scene and settings.traversal (`_make_tracers`):
all-pairs brute force for small scenes, the sweep traversal
(ops/traverse_sweep.py: the CUDA kernel on a card, its twin on the CPU)
with rays sorted by (direction octant, origin Morton) first, the
lockstep cluster walk, or the gather walk of the scene BVH; alpha_test
cuts out transparent texels, inside the gather walk or by re-tracing
past them on the cluster paths. It is a discrete selector: it gets
detached rays and runs under no_grad. Autograd runs through the
shading, which gets the hit attributes either by gathers from the hit
ids (shade_fetch="gather") or from the kernel's in-kernel fetch
(shade_fetch="kernel"), whose backward recomputes them through
shade_hits (_KernelShade). Gradients reach materials, lights, camera
and vertex positions.

Every discrete choice the shading makes from a continuous parameter (a
soft edge's pass-through, the metal lobe, glass against diffuse, reflect
against refract) multiplies the throughput by w / w.detach(): 1 in
value, the derivative of the choice's probability in the gradient. The
clips on those weights go through `_clip`, whose gradient at a bound is
JAX's, half on each side.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from dustraytracer_tpu_torch.ops.intersect import moller_trumbore
from dustraytracer_tpu_torch.ops.rng import (random_float, random_in_ball,
                                             random_unit_vec3, seed_pixels)
from dustraytracer_tpu_torch.ops.tonemap import (gamma_correct,
                                                 uncharted2_filmic)
from dustraytracer_tpu_torch.ops.traverse import (_sample_alpha,
                                                  traverse_anyhit,
                                                  traverse_closest)
from dustraytracer_tpu_torch.ops.traverse_brute import traverse_brute
from dustraytracer_tpu_torch.ops.traverse_cluster import traverse_cluster
from dustraytracer_tpu_torch.ops.traverse_sweep import traverse_cluster_sweep
from dustraytracer_tpu_torch.render.texture import sample_texture
from dustraytracer_tpu_torch.scene.camera import Camera, generate_rays
from dustraytracer_tpu_torch.scene.settings import (DebugMode, LightParams,
                                                    RenderMode,
                                                    RenderSettings)

_PARK = 3.0e37  # origin of dead lanes: their walk ends at the root
TRAVERSALS = ("auto", "sweep", "cluster", "brute", "gather")
SHADINGS = ("reference", "pbr")


def _check_settings(settings: RenderSettings):
    if settings.traversal not in TRAVERSALS:
        raise ValueError(f"settings.traversal={settings.traversal!r} is "
                         f"none of {TRAVERSALS}")
    if settings.shading not in SHADINGS:
        raise ValueError(f"settings.shading={settings.shading!r} is none "
                         f"of {SHADINGS}")


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip: maximum, then minimum. At a bound the gradient is split
    half and half, where torch.clamp passes all of it; a weight exactly
    at a bound (1 - metallic with metallic 0) is common."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _bary_min(bary: torch.Tensor) -> torch.Tensor:
    """min over the last axis as a pairwise minimum chain, as the JAX
    package takes it: its gradient picks one side per pair (half each on
    a tie) rather than dividing by the count of equal entries."""
    return torch.minimum(torch.minimum(bary[..., 0], bary[..., 1]),
                         bary[..., 2])


def _resolve_fetch(scene, settings: RenderSettings) -> str:
    """The triangle-attribute fetch: "kernel" (in-kernel emission) or
    "gather". An explicit "kernel" is honoured or raises ValueError;
    "auto" picks "kernel" on a card for cluster scenes of 12,288 to
    16,384 padded triangles that the sweep traverses (the JAX package's
    measured band), else "gather", and always "gather" on the CPU.
    "onehot" is a TPU workaround and means "gather" here."""
    fetch = settings.shade_fetch
    cb = scene.cluster
    wavefront_only = (settings.smooth_shading or settings.soft_edges > 0.0
                      or settings.alpha_test)
    if fetch == "kernel":
        if wavefront_only:
            raise ValueError(
                "shade_fetch='kernel' is incompatible with "
                "smooth_shading/soft_edges/alpha_test (they need "
                "per-hit wavefront recomputation)")
        if cb is None or cb.uv is None:
            raise ValueError("shade_fetch='kernel' needs cluster "
                             "attribute tables (build_cluster_bvh uv/"
                             "face_nrm/mat)")
        return "kernel"
    if fetch != "auto" or scene.device.type == "cpu":
        return "gather"
    n = scene.tri_pos.shape[0]
    if (12288 <= n <= 16384 and cb is not None and cb.uv is not None
            and not wavefront_only
            and settings.traversal in ("auto", "sweep")
            and cb.n_clusters * cb.k > settings.brute_max_tris):
        return "kernel"
    return "gather"


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] along dim 0. Differentiable gathers go through
    index_select: its backward is an atomic index_add, where the backward
    of table[idx] walks each run of equal indices serially, and here runs
    are long (every ray of one material, every miss lane at triangle 0)."""
    return table.index_select(0, idx.to(torch.int64))


def _fetch_material(scene, mats: torch.Tensor) -> dict:
    """Per-ray material attributes, one packed row gather."""
    tab = torch.cat(
        [scene.mat_albedo, scene.mat_emissive,
         scene.mat_metallic[:, None], scene.mat_roughness[:, None],
         scene.mat_albedo_tex.to(torch.float32)[:, None],
         scene.mat_transmission[:, None], scene.mat_ior[:, None]], dim=1)
    rows = _rows(tab, mats)
    return {"albedo": rows[:, 0:3], "emissive": rows[:, 3:6],
            "metallic": rows[:, 6], "roughness": rows[:, 7],
            "tex": rows[:, 8].to(torch.int32),
            "transmission": rows[:, 9], "ior": rows[:, 10]}


def shade_hits(scene, origin, direction, hit_idx, smooth: bool = False):
    """Hit attributes recomputed from discrete hit ids with one packed
    row gather per ray: world position, viewer-facing normal (geometric,
    or interpolated vertex normals with smooth=True), uv, barycentrics,
    material id, front_face. Miss lanes get finite placeholder values."""
    safe = torch.clamp_min(hit_idx, 0)
    t_n = scene.tri_pos.shape[0]
    cols = [scene.tri_pos.reshape(t_n, 9), scene.tri_face_nrm,
            scene.tri_uv.reshape(t_n, 6),
            scene.tri_mat.to(torch.float32)[:, None]]
    if smooth:
        cols.append(scene.tri_nrm.reshape(t_n, 9))
    rows = _rows(torch.cat(cols, dim=1), safe)
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


class _KernelShade(torch.autograd.Function):
    """Hit attributes whose forward value is the traversal kernel's
    emission (kt, ku, kv, kuv, kfn: no wavefront triangle fetch) and
    whose backward recomputes them through shade_hits (gathers by hit
    id) and pulls the cotangents through that, so the kernel fetch
    reaches tri_pos, tri_uv and the rays like the gather fetch.
    Counterpart of the JAX package's `_kernel_shade` custom VJP."""

    @staticmethod
    def forward(ctx, tri_pos, tri_uv, origin, direction, tri_face_nrm,
                tri_mat, hit_idx, kt, ku, kv, kuv, kfn):
        ctx.save_for_backward(tri_pos, tri_uv, origin, direction,
                              tri_face_nrm, tri_mat, hit_idx)
        ok = hit_idx >= 0
        d_norm = direction / _norm(direction)
        front = (kfn * d_norm).sum(dim=-1) <= 0.0
        return (torch.where(ok, kt, 1.0), torch.where(ok, ku, 0.3),
                torch.where(ok, kv, 0.3),
                torch.where(front[:, None], kfn, -kfn), kuv.clone())

    @staticmethod
    def backward(ctx, *grads):
        *diff, tri_face_nrm, tri_mat, hit_idx = ctx.saved_tensors
        ins = [x.detach().requires_grad_(need)
               for x, need in zip(diff, ctx.needs_input_grad)]
        geo = SimpleNamespace(tri_pos=ins[0], tri_uv=ins[1],
                              tri_face_nrm=tri_face_nrm, tri_mat=tri_mat)
        with torch.enable_grad():
            sh = shade_hits(geo, ins[2], ins[3], hit_idx)
            outs = (sh["t"], sh["bary"][:, 1], sh["bary"][:, 2],
                    sh["normal"], sh["uv"])
        # an output that depends on no differentiable input (the normal
        # when only the rays are) is a constant: leave its cotangent out
        pulled = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
        live = [x for x in ins if x.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pulled], live,
                                       [g for _, g in pulled],
                                       allow_unused=True))
        return (*(next(got) if x.requires_grad else None for x in ins),
                *(None,) * 8)


def _shade_from_kernel(scene, origin, direction, hit_idx, rec):
    """shade_hits' dict assembled from the kernel's emitted attributes
    (rec: t/u/v/uv/face_nrm/mat), differentiable through _KernelShade;
    front_face is a discrete decision read off the emitted normal."""
    t, u, v, normal, uv = _KernelShade.apply(
        scene.tri_pos, scene.tri_uv, origin, direction, scene.tri_face_nrm,
        scene.tri_mat, hit_idx, rec["t"], rec["u"], rec["v"], rec["uv"],
        rec["face_nrm"])
    w = 1.0 - u - v
    d_norm = (direction / _norm(direction)).detach()
    front = (rec["face_nrm"] * d_norm).sum(dim=-1) <= 0.0
    return {"t": t, "bary": torch.stack([w, u, v], dim=-1),
            "world_position": origin + direction * t[:, None],
            "normal": normal, "uv": uv, "material": rec["mat"],
            "front_face": front}


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
    every result (the emitted attributes too) back to ray order, so
    neighbouring threads walk similar paths through the tree. Invisible
    to callers."""
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


def _alpha_retrace_tracers(scene, fast_closest, rounds: int):
    """Alpha cutout on the cluster paths, whose tables carry geometry
    only: trace, sample the albedo alpha at each hit, and re-trace the
    rays whose hit was transparent from just past it, for at most
    `rounds` rounds; a ray still unresolved then counts as a miss. Hit t
    is measured from the original origin, visits add up over rounds, and
    any-hit is "a closest hit exists". Each round traces only the rays
    still unresolved: a ray's result depends on its own origin alone, so
    this is the JAX package's full-wave round with less work."""

    def _alpha_at(o, d, hit_idx):
        safe = torch.clamp_min(hit_idx, 0).to(torch.int64)
        tri = scene.tri_pos[safe]
        _ok, _t, u, v = moller_trumbore(o, d, tri[:, 0], tri[:, 1],
                                        tri[:, 2])
        tuv = scene.tri_uv[safe]
        w = 1.0 - u - v
        uv = w[:, None] * tuv[:, 0] + u[:, None] * tuv[:, 1] \
            + v[:, None] * tuv[:, 2]
        tex = scene.mat_albedo_tex[scene.tri_mat[safe].to(torch.int64)]
        return _sample_alpha(scene, tex, uv)

    def closest(o, d):
        n = o.shape[0]
        dev = o.device
        cur_o = o.clone()
        off = torch.zeros((n,), dtype=torch.float32, device=dev)
        idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
        tt = torch.full((n,), 3.4e38, dtype=torch.float32, device=dev)
        vis = torch.zeros((n,), dtype=torch.int32, device=dev)
        live = torch.arange(n, device=dev)
        for _ in range(rounds):
            if not live.numel():
                break
            lo, ld = cur_o[live], d[live]
            r = fast_closest(lo, ld)
            hit = r["hit_idx"] >= 0
            accept = hit & (_alpha_at(lo, ld, r["hit_idx"]) >= 1.0)
            idx[live[accept]] = r["hit_idx"][accept]
            tt[live[accept]] = off[live[accept]] + r["t"][accept]
            vis[live] += r["visits"]
            # restart transparent rays just past the rejected hit: too
            # small an advance re-hits the same triangle (at t below the
            # 1e-6 cutoff, so harmless), too large skips opaque geometry
            # nearly coincident with the cutout
            adv = r["t"] * (1.0 + 1e-5) + 1e-5
            transparent = hit & ~accept
            moved = live[transparent]
            cur_o[moved] = lo[transparent] \
                + ld[transparent] * adv[transparent][:, None]
            off[moved] = off[moved] + adv[transparent]
            live = moved
        return {"hit_idx": idx, "t": tt, "visits": vis}

    def anyhit(o, d):
        return closest(o, d)["hit_idx"] >= 0

    return closest, anyhit


def _make_tracers(scene, settings: RenderSettings):
    """Pick the traversal backend from the scene and settings.traversal:

    - brute: forced, or `auto` on a cluster scene of at most
      brute_max_tris padded triangles;
    - sweep: forced, or `auto` otherwise (the CUDA kernel on a card, its
      twin on the CPU); the closest-hit tracer emits the shading
      attributes when settings.shade_fetch == "kernel";
    - cluster: the lockstep walk of the base threading;
    - gather, or a scene without cluster tables: the scene-BVH walk,
      which applies alpha_test itself.

    Sweep rays are sorted (ray_sort "auto" or "on"; the others only with
    "on"). alpha_test on a cluster path re-traces past transparent hits.
    Both tracers detach their rays and run under no_grad."""
    cb = scene.cluster
    trav = settings.traversal
    if trav in ("cluster", "brute", "sweep") and cb is None:
        raise ValueError(f"settings.traversal={trav!r} but the scene was "
                         "built without cluster tables (cluster_k=None)")
    use_cluster = cb is not None and trav != "gather"
    use_brute = use_cluster and (
        trav == "brute" or (trav == "auto" and cb.n_clusters * cb.k
                            <= settings.brute_max_tris))
    use_sweep = use_cluster and not use_brute and trav in ("auto", "sweep")
    emit = settings.shade_fetch == "kernel"
    if emit and not use_sweep:
        raise ValueError("shade_fetch='kernel' requires the sweep "
                         "traversal backend")
    if use_brute:
        def closest(o, d):
            return traverse_brute(cb, o, d)

        def anyhit(o, d):
            return traverse_brute(cb, o, d, anyhit=True)["hit_idx"] >= 0
    elif use_sweep:
        def closest(o, d):
            return traverse_cluster_sweep(cb, o, d, emit_attrs=emit)

        def anyhit(o, d):
            return traverse_cluster_sweep(cb, o, d,
                                          anyhit=True)["hit_idx"] >= 0
    elif use_cluster:
        def closest(o, d):
            return traverse_cluster(cb, o, d)

        def anyhit(o, d):
            return traverse_cluster(cb, o, d, anyhit=True)["hit_idx"] >= 0
    else:
        def closest(o, d):
            return traverse_closest(scene, o, d,
                                    alpha_test=settings.alpha_test)

        def anyhit(o, d):
            return traverse_anyhit(scene, o, d,
                                   alpha_test=settings.alpha_test)

    if settings.ray_sort == "on" or (settings.ray_sort == "auto"
                                     and use_sweep):
        closest, anyhit = _sorted_tracers(scene, closest, anyhit)
    if use_cluster and settings.alpha_test:
        closest, anyhit = _alpha_retrace_tracers(
            scene, closest, rounds=settings.alpha_rounds)

    def _no_grad_in(f):  # the JAX package's _sg_in
        def g(o, d):
            with torch.no_grad():
                return f(o.detach().contiguous(), d.detach().contiguous())
        return g

    return _no_grad_in(closest), _no_grad_in(anyhit)


def _ratio(w: torch.Tensor, lo: float, apply: torch.Tensor) -> torch.Tensor:
    """w / w.detach() on `apply` lanes, 1 elsewhere, with w clipped to
    [lo, 1]: 1 in value, d log w in the gradient."""
    w = _clip(w, lo, 1.0)
    return torch.where(apply, w / w.detach(), 1.0)


def _soft_edges(trace_closest, scene, lights, settings, origin, direction,
                o_live, res, alive, hit_idx, u_edge, throughput, light):
    """The edge of each live hit made differentiable. A continuation is
    traced from a hair past the hit. A lane keeps its hit with
    probability sigma = 1 - exp(-b_min / soft_edges), b_min its smallest
    barycentric, or passes through to what the continuation hit, and the
    recorded choice is reweighted by w / w.detach(); where the
    continuation escaped, the lane keeps its hit and blends toward the
    sky deterministically (light += (1 - sigma) sky, throughput *=
    sigma). Returns (hit_idx, throughput, light)."""
    hit0 = alive & (hit_idx >= 0)
    sh_e = shade_hits(scene, origin, direction, hit_idx)
    # double where: the dead lanes' barycentrics must not reach a gradient
    b_min = torch.where(hit0, _bary_min(sh_e["bary"]), 0.5)
    sigma = 1.0 - torch.exp(-_clip(b_min, 0.0, 1.0) / settings.soft_edges)
    adv = torch.where(hit0, res["t"] * (1.0 + 1e-4) + 1e-4, 0.0)
    # lanes with no hit need no continuation: they park
    o2 = torch.where(hit0[:, None], o_live + direction.detach()
                     * adv[:, None], _PARK)
    res2 = trace_closest(o2, direction)
    cont_miss = hit0 & (res2["hit_idx"] < 0)
    pass_th = hit0 & ~cont_miss & (u_edge >= sigma.detach())
    light = light + torch.where(
        cont_miss[:, None], throughput * (1.0 - sigma)[:, None]
        * _sky(direction, lights) * lights.sky_intensity, 0.0)
    det_scale = torch.where(cont_miss, sigma, 1.0)
    ratio = _ratio(torch.where(pass_th, 1.0 - sigma, sigma), 1e-4,
                   hit0 & ~cont_miss)
    return (torch.where(pass_th, res2["hit_idx"], hit_idx),
            throughput * (ratio * det_scale)[:, None], light)


def _pbr_bounce(sh, matd, direction, ball, bounce_dir, new_origin,
                throughput, live_hit, rng):
    """The metal lobe and glass, after the diffuse bounce. A lane turns
    metal with P = metallic (mirror direction + roughness * ball); a
    lane that did not transmits with P = transmission, by Snell or by a
    mirror reflection on total internal reflection or a Schlick-Fresnel
    coin, fuzzed by roughness * ball, and a transmitted ray starts just
    behind the surface. Returns (bounce_dir, new_origin, throughput,
    rng)."""
    rng, u_lobe = random_float(rng)
    metallic = matd["metallic"]
    roughness = matd["roughness"][:, None]
    nrm = sh["normal"]  # viewer-facing, so cos_in >= 0
    d_n = direction / _norm(direction)
    refl = d_n - 2.0 * (d_n * nrm).sum(dim=-1, keepdim=True) * nrm
    is_metal = u_lobe < metallic.detach()
    bounce_dir = torch.where(is_metal[:, None], refl + roughness * ball,
                             bounce_dir)
    throughput = throughput * _ratio(
        torch.where(is_metal, metallic, 1.0 - metallic), 1e-3,
        live_hit)[:, None]

    rng, u_glass = random_float(rng)
    rng, u_fresnel = random_float(rng)
    transm = matd["transmission"]
    ior = torch.maximum(matd["ior"], matd["ior"].new_tensor(1.0 + 1e-4))
    is_glass = ~is_metal & (u_glass < transm.detach())
    eta = torch.where(sh["front_face"], 1.0 / ior, ior)
    cos_in = _clip(-(d_n * nrm).sum(dim=-1), 0.0, 1.0)
    k = 1.0 - eta * eta * (1.0 - cos_in * cos_in)
    tir = k < 0.0
    # double where: sqrt'(0) = inf would turn the TIR lanes' zero
    # cotangent into NaN in d/d(ior)
    k_safe = torch.where(tir, 1.0, torch.maximum(k, k.new_tensor(0.0)))
    refr = (eta[:, None] * (d_n + cos_in[:, None] * nrm)
            - torch.sqrt(k_safe)[:, None] * nrm)
    r0 = (1.0 - eta) / (1.0 + eta)
    r0 = r0 * r0
    # (1 - cos)^5 multiplied out as XLA's integer_pow does it
    c = 1.0 - cos_in
    c2 = c * c
    fres = _clip(r0 + (1.0 - r0) * (c * (c2 * c2)), 0.0, 1.0)
    reflect = tir | (u_fresnel < fres.detach())
    glass_dir = torch.where(reflect[:, None], refl, refr) + roughness * ball
    bounce_dir = torch.where(is_glass[:, None], glass_dir, bounce_dir)
    transmitted = is_glass & ~reflect
    new_origin = torch.where(transmitted[:, None],
                             sh["world_position"] - nrm * 1e-3, new_origin)
    # a metal lane never flipped the glass coin: its weight is 1, so
    # d/d(transmission) stays unbiased when metallic > 0
    w_g = torch.where(is_glass, transm,
                      torch.where(is_metal, 1.0, 1.0 - transm))
    w_f = torch.where(is_glass & ~tir,
                      torch.where(reflect, fres, 1.0 - fres), 1.0)
    throughput = throughput * _ratio(w_g * w_f, 1e-3, live_hit)[:, None]
    return bounce_dir, new_origin, throughput, rng


def _segment(scene, lights: LightParams, settings: RenderSettings, tracers,
             carry, bounce_idx: int):
    """One path segment for all rays. The RNG stream is drawn in the JAX
    package's order: u_edge, sun jitter, u_rr, ball, the cosine sample,
    u_lobe, u_glass, u_fresnel."""
    origin, direction, throughput, light, alive, rng = carry
    sun_pos = lights.sun_position()
    sun_col = lights.sun_color * lights.sun_intensity
    trace_closest, trace_anyhit = tracers
    pbr = settings.shading == "pbr"

    # dead lanes park far away (traversal only: shading sees `origin`)
    o_live = torch.where(alive[:, None], origin.detach(), _PARK)
    res = trace_closest(o_live, direction)
    hit_idx = torch.where(alive, res["hit_idx"], -1)
    if settings.soft_edges > 0.0:
        rng, u_edge = random_float(rng)
        hit_idx, throughput, light = _soft_edges(
            trace_closest, scene, lights, settings, origin, direction,
            o_live, res, alive, hit_idx, u_edge, throughput, light)
    miss = hit_idx < 0
    live_hit = alive & ~miss

    # sky on miss
    sky = _sky(direction, lights)
    light = light + torch.where((alive & miss)[:, None],
                                throughput * sky * lights.sky_intensity, 0.0)

    if settings.shade_fetch == "kernel":
        sh = _shade_from_kernel(scene, origin, direction, hit_idx, res)
    else:
        sh = shade_hits(scene, origin, direction, hit_idx,
                        smooth=settings.smooth_shading)
    matd = _fetch_material(scene, sh["material"])
    if pbr:  # emission, before the albedo multiply
        light = light + torch.where(live_hit[:, None],
                                    throughput * matd["emissive"], 0.0)
    alb = _albedo(scene, matd, sh["uv"],
                  bilinear=settings.tex_filter == "bilinear")
    throughput = torch.where(live_hit[:, None], throughput * alb, throughput)
    new_origin = sh["world_position"] + sh["normal"] * 1e-3

    # sun NEE shadow ray
    if settings.enable_sunlight:
        rng, jit_vec = random_unit_vec3(rng)
        shadow_dir = sun_pos[None, :] + jit_vec * 1.5
        nee_o = torch.where(live_hit[:, None], new_origin.detach(), _PARK)
        occluded = trace_anyhit(nee_o, shadow_dir)
        contrib = sun_col[None, :] * throughput
        if pbr:
            # only the (1 - transmission) reflected share of a dielectric
            # sees the sun; the shadow ray still treats glass as opaque
            contrib = contrib * (1.0 - (1.0 - matd["metallic"])
                                 * matd["transmission"])[:, None]
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
    if pbr:
        bounce_dir, new_origin, throughput, rng = _pbr_bounce(
            sh, matd, direction, ball, bounce_dir, new_origin, throughput,
            live_hit, rng)

    return new_origin, bounce_dir, throughput, light, alive, rng


def _debug_view(scene, lights: LightParams, settings: RenderSettings,
                trace_closest, origin, direction) -> torch.Tensor:
    """One closest trace of the camera rays and the debug head of
    settings.debug_mode: ALBEDO (albedo on a hit, sky on a miss), NORMAL,
    BARYCENTRIC, UVS (u, v, 0), or BVH / WORLD_BVH (visits * 0.05 over a
    base of (0, 0.1, 0.1) on a hit); zero on a miss but for ALBEDO and
    the heat."""
    res = trace_closest(origin, direction)
    hit_idx = res["hit_idx"]
    live_hit = (hit_idx >= 0)[:, None]
    if settings.shade_fetch == "kernel":
        sh = _shade_from_kernel(scene, origin, direction, hit_idx, res)
    else:
        sh = shade_hits(scene, origin, direction, hit_idx,
                        smooth=settings.smooth_shading)
    dm = settings.debug_mode
    if dm == DebugMode.ALBEDO:
        alb = _albedo(scene, _fetch_material(scene, sh["material"]),
                      sh["uv"], bilinear=settings.tex_filter == "bilinear")
        sky = _sky(direction, lights) * lights.sky_intensity
        return torch.where(live_hit, alb, sky)
    if dm in (DebugMode.BVH, DebugMode.WORLD_BVH):
        heat = res["visits"].to(torch.float32)[:, None] * 0.05
        base = torch.tensor([0.0, 0.1, 0.1], device=origin.device)
        return torch.where(live_hit, base, 0.0) + heat
    if dm == DebugMode.NORMAL:
        view = sh["normal"]
    elif dm == DebugMode.BARYCENTRIC:
        view = sh["bary"]
    else:  # UVS
        view = torch.cat([sh["uv"], torch.zeros_like(sh["uv"][:, :1])],
                         dim=-1)
    return torch.where(live_hit, view, 0.0)


def render_pixels(scene, camera: Camera, lights: LightParams, frame_idx: int,
                  pixel_ids: torch.Tensor, *, width: int, height: int,
                  settings: RenderSettings) -> torch.Tensor:
    """Render one sample for a flat batch of pixel ids -> (N, 3) colour,
    on the scene's device; differentiable in the scene's float tables,
    the camera and the lights (wrap in torch.inference_mode() to render
    without a graph). Tonemap and gamma apply in NORMAL mode and to the
    ALBEDO debug view only."""
    _check_settings(settings)
    # resolve the fetch once, so the tracers and every segment agree
    settings = settings.replace(shade_fetch=_resolve_fetch(scene, settings))
    n = pixel_ids.shape[0]
    dev = pixel_ids.device
    rng = seed_pixels(pixel_ids, frame_idx)
    rng, origin, direction = generate_rays(camera, width, height, rng,
                                           pixel_ids=pixel_ids)
    tracers = _make_tracers(scene, settings)
    if settings.render_mode == RenderMode.DEBUG:
        color = _debug_view(scene, lights, settings, tracers[0], origin,
                            direction)
        post = settings.debug_mode == DebugMode.ALBEDO
    else:
        carry = (origin, direction,
                 torch.ones((n, 3), dtype=torch.float32, device=dev),
                 torch.zeros((n, 3), dtype=torch.float32, device=dev),
                 torch.ones((n,), dtype=torch.bool, device=dev), rng)
        for bounce_idx in range(settings.bounces):
            carry = _segment(scene, lights, settings, tracers, carry,
                             bounce_idx)
        color = carry[3]
        post = True
    if not post:
        return color
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
