"""Inverse rendering CLI: gradient descent on scene parameters (port of
apps/optimize.py).

Renders a target (or reads a PNG), scrambles the chosen parameters and
recovers them with Adam through the differentiable renderer on one
device, checkpointing as it goes.

Usage:
  python -m dustraytracer_tpu_torch.apps.optimize --scene x.glb \\
      --self-test --optimize albedo lights --steps 100 --out recovered/

The self-test scramble draws with numpy from a fixed seed. Parameters
that only PBR shading sees (emissive, metallic, roughness, transmission,
ior) switch the render to shading="pbr"; `textures` first decodes the u8
texture stack to linear float32 texels (render/texture.py
decode_textures); `vertices` renders with soft edges 0.05 unless
--soft-edges says otherwise. Pixels sharded over devices (--devices)
are not ported yet and raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from dustraytracer_tpu_torch.ops import traverse_sweep as ts
from dustraytracer_tpu_torch.parallel.shard import apply_params
from dustraytracer_tpu_torch.render.integrator import (render_pixels,
                                                       render_sample)
from dustraytracer_tpu_torch.render.texture import decode_textures
from dustraytracer_tpu_torch.scene import load_scene, make_camera
from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                    RenderSettings)
from dustraytracer_tpu_torch.utils.checkpoint import (load_train_state,
                                                      param_leaves,
                                                      save_train_state)
from dustraytracer_tpu_torch.utils.image import save_png

PARAM_KEYS = {
    "albedo": "mat_albedo",
    "emissive": "mat_emissive",
    "roughness": "mat_roughness",
    "metallic": "mat_metallic",
    "transmission": "mat_transmission",
    "ior": "mat_ior",
    "vertices": "tri_pos",
    "textures": "tex_stack",
}

# physical ranges, projected after every update (Adam can otherwise walk
# weakly observed parameters far out of their domain and strand them)
PARAM_BOUNDS = {
    "mat_albedo": (0.0, 1.0),
    "mat_emissive": (0.0, None),
    "mat_roughness": (0.0, 1.0),
    "mat_metallic": (0.0, 1.0),
    "mat_transmission": (0.0, 1.0),
    # above the integrator's max(ior, 1 + 1e-4) clamp, whose gradient is
    # zero at 1.0
    "mat_ior": (1.01, 3.0),
    "tex_stack": (0.0, 1.0),
}

PBR_PARAMS = ("emissive", "metallic", "roughness", "transmission", "ior")
SCRAMBLE_SEED = 0


def build_parser():
    p = argparse.ArgumentParser(prog="dustraytracer_tpu_torch.optimize")
    p.add_argument("--scene", required=True)
    p.add_argument("--target", help="target PNG (linear fit happens in "
                   "tonemapped space); omit with --self-test")
    p.add_argument("--self-test", action="store_true",
                   help="render target from true params, scramble, recover")
    p.add_argument("--optimize", nargs="+", default=["albedo"],
                   choices=["albedo", "emissive", "roughness", "metallic",
                            "transmission", "ior",
                            "lights", "camera", "vertices", "textures"])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=2e-2)
    p.add_argument("--size", default="128x128")
    p.add_argument("--spp-per-step", type=int, default=1)
    p.add_argument("--bounces", type=int, default=2)
    p.add_argument("--camera-pos", default="0,1,4")
    p.add_argument("--look-at", default="0,1,0")
    p.add_argument("--vfov", type=float, default=60.0)
    p.add_argument("--devices", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' PyTorch twins); the "
                   "default needs a CUDA card")
    p.add_argument("--out", default="optimize_out")
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--resume", action="store_true",
                   help="continue from {out}/ckpt if present (params + "
                   "optimizer state + step)")
    p.add_argument("--stochastic", action="store_true",
                   help="vary the RNG frame per step (noisy loss); default "
                   "keeps the sample deterministic")
    p.add_argument("--perturb-vertices", type=float, default=0.0,
                   help="self-test vertex init: true + U(-s, s) offset "
                   "instead of the default 0.5*true + 0.25*U scramble")
    p.add_argument("--soft-edges", type=float, default=None,
                   help="differentiable silhouettes (settings.soft_edges); "
                   "default: 0.05 when optimizing vertices, else 0")
    p.add_argument("--nee-cosine", action="store_true",
                   help="N*L on sun NEE")
    return p


def _not_ported(what: str):
    return NotImplementedError(f"{what} not yet ported, see ROADMAP.md")


def project_params(params: dict) -> dict:
    """Clamp bounded parameters into PARAM_BOUNDS, in place."""
    with torch.no_grad():
        for k, (lo, hi) in PARAM_BOUNDS.items():
            if k in params:
                params[k].clamp_(min=lo, max=hi)
    return params


def as_leaves(params: dict) -> dict:
    """Copies of the params as leaf tensors that require grad."""
    def leaf(t):
        return t.detach().clone().requires_grad_(True)

    out = {}
    for k, v in params.items():
        if dataclasses.is_dataclass(v):
            out[k] = dataclasses.replace(
                v, **{f.name: leaf(getattr(v, f.name))
                      for f in dataclasses.fields(v)})
        else:
            out[k] = leaf(v)
    return out


def scramble(scene, names, self_test: bool, perturb_vertices: float = 0.0,
             seed: int = SCRAMBLE_SEED) -> dict:
    """Initial scene parameters: the true values, or with `self_test`
    0.5 * true + 0.25 * U(0, 1) (vertices: true + U(-s, s) when
    `perturb_vertices` = s > 0), drawn with numpy in `names` order."""
    rng = np.random.default_rng(seed)
    params = {}
    for name in names:
        if name in ("lights", "camera"):
            continue
        k = PARAM_KEYS[name]
        true = getattr(scene, k)
        if self_test:
            shape = tuple(true.shape)
            if name == "vertices" and perturb_vertices > 0:
                off = rng.uniform(-perturb_vertices, perturb_vertices, shape)
                init = true + torch.from_numpy(
                    off.astype(np.float32)).to(true.device)
            else:
                u = rng.uniform(size=shape).astype(np.float32)
                init = true * 0.5 + 0.25 * torch.from_numpy(u).to(true.device)
        else:
            init = true
        params[k] = init
    return params


def make_loss_fn(scene, camera, lights, target, *, width: int, height: int,
                 settings):
    """loss(params, frame): mean squared error of one rendered sample
    against `target` (H, W, 3), over all pixels and channels."""
    n = width * height
    ids = torch.arange(n, device=scene.device)
    tgt = target.reshape(n, 3)

    def loss_fn(params, frame: int):
        sc, c, li = apply_params(scene, camera, lights, params)
        color = render_pixels(sc, c, li, frame, ids, width=width,
                              height=height, settings=settings)
        return ((color - tgt) ** 2).sum() / (n * 3)

    return loss_fn


def make_optimizer(params: dict, lr: float):
    """Adam over the params' leaves with optax.adam's defaults (b1 0.9,
    b2 0.999, eps 1e-8 outside the square root)."""
    return torch.optim.Adam(param_leaves(params), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def train_step(params: dict, optimizer, loss_fn, frame: int):
    """One Adam step and projection, in place; returns the loss before
    the step. A leaf the loss does not reach gets a zero gradient, as in
    JAX, so every Adam moment decays each step as optax's does (with one
    bounce and hard edges, say, the image does not depend on vertices)."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(params, frame)
    if loss.requires_grad:
        loss.backward()
    for t in param_leaves(params):
        if t.grad is None:
            t.grad = torch.zeros_like(t)
    optimizer.step()
    project_params(params)
    return loss.detach()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.devices > 0:
        raise _not_ported("--devices (pixels sharded over devices)")
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False (pass --cpu "
                           "to run on the CPU)")
    device = torch.device("cpu" if args.cpu else "cuda")

    os.makedirs(args.out, exist_ok=True)
    w, h = (int(x) for x in args.size.split("x"))
    scene = load_scene(args.scene).to(device)
    if "textures" in args.optimize:
        scene = decode_textures(scene)
    cam = make_camera(
        position=tuple(float(x) for x in args.camera_pos.split(",")),
        look_at=tuple(float(x) for x in args.look_at.split(",")),
        vfov_deg=args.vfov, device=device)
    soft = args.soft_edges
    if soft is None:
        soft = 0.05 if "vertices" in args.optimize else 0.0
    pbr = any(p in args.optimize for p in PBR_PARAMS)
    settings = RenderSettings(bounces=args.bounces, enable_tonemap=False,
                              enable_gamma=False, nee_cosine=args.nee_cosine,
                              soft_edges=float(soft),
                              shading="pbr" if pbr else "reference")
    lights = LightParams.from_settings(settings, device=device)

    # --- target ---
    if args.self_test or not args.target:
        # the target uses the RNG frame the training step renders with,
        # so the loss is 0 at the true parameters
        tgt_frame = 9999 if args.stochastic else 0
        with torch.inference_mode():
            target = render_sample(scene, cam, lights, tgt_frame, width=w,
                                   height=h, settings=settings)
        save_png(f"{args.out}/target.png", target.clamp(0, 1))
    else:
        from PIL import Image

        img = np.asarray(Image.open(args.target).convert("RGB"),
                         np.float32)[::-1] / 255.0
        target = torch.from_numpy(np.ascontiguousarray(img)).to(device)

    # --- initial (scrambled) params, Adam ---
    params = scramble(scene, args.optimize, args.self_test,
                      args.perturb_vertices)
    if "lights" in args.optimize:
        params["lights"] = lights
    if "camera" in args.optimize:
        params["camera"] = cam
    params = as_leaves(params)
    optimizer = make_optimizer(params, args.lr)

    start_step = 0
    if args.resume:
        restored = load_train_state(f"{args.out}/ckpt", params, optimizer)
        if restored is not None:
            params, _, start_step = restored
            print(f"resumed from step {start_step}", file=sys.stderr)

    loss_fn = make_loss_fn(scene, cam, lights, target, width=w, height=h,
                           settings=settings)
    history = []
    launches0 = (ts.LAUNCHES, ts.EMIT_LAUNCHES)
    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        frame = step % 64 if args.stochastic else 0
        loss = train_step(params, optimizer, loss_fn, frame)
        if step % 10 == 0 or step == args.steps - 1:
            val = float(loss)
            history.append({"step": step, "loss": val,
                            "t": round(time.perf_counter() - t0, 2)})
            print(f"step {step:5d}  loss {val:.6f}", file=sys.stderr)
        if args.checkpoint_every and step and \
                step % args.checkpoint_every == 0:
            save_train_state(f"{args.out}/ckpt", params, optimizer,
                             step=step)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.perf_counter() - t0
    launches = [ts.LAUNCHES - launches0[0], ts.EMIT_LAUNCHES - launches0[1]]

    # --- report ---
    with torch.inference_mode():
        sc, c, li = apply_params(scene, cam, lights, params)
        final = render_sample(sc, c, li, 9999, width=w, height=h,
                              settings=settings)
    save_png(f"{args.out}/final.png", final.clamp(0, 1))
    n_steps = args.steps - start_step
    result = {"history": history,
              "final_loss": history[-1]["loss"] if history else None,
              "seconds_per_step": train_s / n_steps if n_steps > 0 else None,
              # traversal kernel launches in the steps: closest/any-hit,
              # and with emit_attrs (both 0 on the CPU, which runs the twin)
              "traversal_launches": launches}
    if args.self_test:
        errs = {}
        for name in args.optimize:
            if name in ("lights", "camera"):
                continue
            k = PARAM_KEYS[name]
            true = getattr(scene, k).detach().cpu().numpy()
            got = params[k].detach().cpu().numpy()
            errs[k] = float(np.abs(true - got).mean())
        result["param_mae"] = errs
    print(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
