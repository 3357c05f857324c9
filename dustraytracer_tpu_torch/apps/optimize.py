"""Inverse rendering CLI: gradient descent on scene parameters (port of
apps/optimize.py).

Renders a target (or reads a PNG), scrambles the chosen parameters and
recovers them with Adam through the differentiable renderer,
checkpointing as it goes; `--devices N` splits the pixels over N devices
(the first N cards, or with --cpu N tiles on the CPU) and sums the
tiles' gradients into the one parameter set (parallel/shard.py).

Usage:
  python -m dustraytracer_tpu_torch.apps.optimize --scene x.glb \\
      --self-test --optimize albedo lights --steps 100 --out recovered/

The self-test scramble draws with numpy from a fixed seed. Parameters
that only PBR shading sees (emissive, metallic, roughness, transmission,
ior) switch the render to shading="pbr"; `textures` first decodes the u8
texture stack to linear float32 texels (render/texture.py
decode_textures); `vertices` renders with soft edges 0.05 unless
--soft-edges says otherwise.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import inspect
import json
import os
import sys
import time
import warnings
import weakref

import numpy as np
import torch

from dustraytracer_tpu_torch.parallel.mesh import (make_render_mesh,
                                                   replicate_scene)
from dustraytracer_tpu_torch.parallel.shard import (apply_params,
                                                    sharded_loss)
from dustraytracer_tpu_torch.render import graphed
from dustraytracer_tpu_torch.render.integrator import (render_pixels,
                                                       render_sample,
                                                       reporting_to)
from dustraytracer_tpu_torch.render.texture import decode_textures
from dustraytracer_tpu_torch.scene import load_scene, make_camera
from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                    RenderSettings)
from dustraytracer_tpu_torch.utils.checkpoint import (load_train_state,
                                                      param_leaves,
                                                      save_train_state)
from dustraytracer_tpu_torch.utils import profiling
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
    p.add_argument("--devices", type=int, default=0,
                   help="split the pixels over N devices (tiles); with "
                   "--cpu, N tiles on the CPU")
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
    p.add_argument("--trace", metavar="DIR",
                   help="run the optimisation under profiling.trace(DIR): "
                   "writes DIR/trace.json and DIR/spans.json")
    return p


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
                 settings, mesh=None):
    """loss(params, frame): mean squared error of one rendered sample
    against `target` (H, W, 3), over all pixels and channels; `frame` an
    int or a 0-d int64 tensor on the card (train_step's graphs). With a
    `mesh` the pixels split over its devices: the sum of the tiles'
    squared errors over the global n * 3 (parallel/shard.py)."""
    n = width * height
    if mesh is not None:
        scenes = replicate_scene(scene, mesh)

        def sharded(params, frame: int):
            return sharded_loss(params, scenes, camera, lights, target,
                                frame, mesh=mesh, width=width,
                                height=height, settings=settings,
                                norm=n * 3)

        return sharded
    ids = torch.arange(n, device=scene.device)
    tgt = target.reshape(n, 3)

    def loss_fn(params, frame):
        sc, c, li = apply_params(scene, camera, lights, params)
        color = render_pixels(sc, c, li, frame, ids, width=width,
                              height=height, settings=settings)
        return ((color - tgt) ** 2).sum() / (n * 3)

    return loss_fn


def make_optimizer(params: dict, lr: float):
    """Adam over the params' leaves with optax.adam's defaults (b1 0.9,
    b2 0.999, eps 1e-8 outside the square root); capturable where every
    leaf is on a card (its step count on the card, so that train_step
    can replay it in a CUDA graph)."""
    leaves = param_leaves(params)
    return torch.optim.Adam(
        leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
        capturable=all(t.device.type == "cuda" for t in leaves))


def _step_stages(params: dict, optimizer, loss_fn, frame,
                 record: graphed.ForwardRecord) -> list:
    """train_step's body as (span name, stage) pairs, which the eager
    step runs and the graphed step captures: the forward (the loss, with
    its render_pixels calls reported to `record`, and the sum of the
    live lanes it recorded), the backward (drt.bwd.loss runs from the
    call to the last bounce's drt.bwd.b{i}, which a gradient hook opens),
    Adam (after a zero gradient for each leaf the loss does not reach,
    as in JAX, so that every Adam moment decays each step as optax's
    does) and the projection. A stage maps the state dict (None into the
    first) to the next."""
    def forward(_):
        with reporting_to(record):
            loss = loss_fn(params, frame)
        live = torch.stack(record.live).sum() if record.live else None
        return {"loss": loss, "live": live}

    def backward(s):
        if s["loss"].requires_grad:
            profiling.chain("drt.bwd.loss")
            s["loss"].backward()
            profiling.end_chain()
        return s

    def adam(s):
        for t in param_leaves(params):
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        optimizer.step()
        return s

    def project(s):
        project_params(params)
        return s

    return [("drt.step.forward", forward), ("drt.step.backward", backward),
            ("drt.step.adam", adam), ("drt.step.project", project)]


def _run_eager(stages) -> dict:
    state = None
    for name, stage in stages:
        with profiling.span(name):
            state = stage(state)
    return state


def _ref(fn):
    return (weakref.WeakMethod(fn) if inspect.ismethod(fn)
            else weakref.ref(fn))


class _StepKey:
    """What a captured step bakes in: the loss function and the optimizer
    (by weak reference), the optimizer's hyperparameters, the leaves'
    addresses and shapes; `matches` compares a step's call with it."""

    def __init__(self, leaves, optimizer, loss_fn):
        self.loss_fn, self.optimizer = _ref(loss_fn), _ref(optimizer)
        self.rest = self._rest(leaves, optimizer)

    @staticmethod
    def _rest(leaves, optimizer) -> tuple:
        hyper = tuple(tuple((k, v) for k, v in sorted(g.items())
                            if k != "params")
                      for g in optimizer.param_groups)
        return hyper, tuple((t.data_ptr(), t.shape) for t in leaves)

    def matches(self, leaves, optimizer, loss_fn) -> bool:
        return (self.loss_fn() == loss_fn
                and self.optimizer() is optimizer
                and self.rest == self._rest(leaves, optimizer))


@dataclasses.dataclass
class _Decided:
    """An eager warm-up step's verdict on its key: `reason` it stays
    eager (None: the next step captures), and the settings its forward
    rendered with."""
    key: _StepKey
    reason: str | None
    settings: list

    def matches(self, leaves, optimizer, loss_fn) -> bool:
        return self.key.matches(leaves, optimizer, loss_fn)


class _StepGraphs:
    """The step captured as four CUDA graphs in one pool (render/graphed.py
    capture): the forward with the frame as a static 0-d int64 tensor,
    the backward into static .grads, Adam and the projection. `ok` is
    False where the capture's forward reported other settings or reasons
    than the warm-up's."""

    def __init__(self, decided: _Decided, params, optimizer, loss_fn, dev):
        self.key = decided.key
        leaves = param_leaves(params)
        with torch.cuda.device(dev):
            self.frame = torch.zeros((), dtype=torch.int64, device=dev)
            record = graphed.ForwardRecord(capturing=True)
            # the backward allocates the .grads in the pool; no step sets
            # them to None after this
            optimizer.zero_grad(set_to_none=True)
            with profiling.muted(), warnings.catch_warnings():
                # a stage with nothing to do (a projection with no
                # bounded leaf) captures an empty graph
                warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                self.graphs, state = graphed.capture(
                    _step_stages(params, optimizer, loss_fn, self.frame,
                                 record), dev)
        self.ok = (record.reason(dev) is None
                   and record.settings() == decided.settings)
        self.loss, self.live = state["loss"], state["live"]
        self.n_lanes = record.n_lanes
        # the addresses the graphs write: a step that finds them replaced
        # (a load of Adam's state, a zero_grad) captures anew
        self.buffers = self._buffers(leaves, optimizer)

    @staticmethod
    def _buffers(leaves, optimizer) -> list:
        return [b for t in leaves
                for b in (t.grad, *optimizer.state.get(t, {}).values())]

    def matches(self, leaves, optimizer, loss_fn) -> bool:
        now = self._buffers(leaves, optimizer)
        return (self.key.matches(leaves, optimizer, loss_fn)
                and len(now) == len(self.buffers)
                and all(a is b for a, b in zip(now, self.buffers)))

    def step(self, frame: int) -> torch.Tensor:
        """Replay the step at `frame` in the eager step's spans; a clone
        of the loss, which the next replay overwrites."""
        graphed.replay(self.graphs, lambda: self.frame.fill_(frame))
        if profiling.enabled():
            profiling.count("drt.step.replayed")
            if self.live is not None:
                profiling.count("drt.k4.lanes", self.n_lanes)
                profiling.count_device("drt.k4.live_lanes", self.live)
        return self.loss.detach().clone()


_STEPS = {}  # card -> its _Decided or _StepGraphs


def _card(leaves):
    """The one CUDA device of every leaf, or the reason there is none."""
    devs = {t.device for t in leaves}
    if len(devs) != 1:
        return None, f"leaves on {sorted(map(str, devs))}: not one card"
    (dev,) = devs
    if dev.type != "cuda":
        return None, f"device {dev} is not CUDA"
    return dev, None


def step_reason(params: dict, optimizer, loss_fn) -> str | None:
    """Why train_step runs this call eagerly, as graphed.eager_reason
    says it of a sample: None where it replays (or its next step
    captures)."""
    leaves = param_leaves(params)
    dev, reason = _card(leaves)
    if dev is None:
        return reason
    got = _STEPS.get(dev)
    if got is None or not got.key.matches(leaves, optimizer, loss_fn):
        return "no eager warm-up step of this loss and optimizer yet"
    return got.reason if isinstance(got, _Decided) else None


def _warm_up(stages) -> tuple:
    """The eager step that decides: its state, and why it cannot be
    captured (a wait for the card, as set_sync_debug_mode("warn")
    reports it; the forward's record), or None."""
    before = torch.cuda.get_sync_debug_mode()
    if not before:  # "error" stays: a wait raises, as the caller asked
        torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            state = _run_eager(stages)
    finally:
        torch.cuda.set_sync_debug_mode(before)
    waits = [w for w in caught if "synchroniz" in str(w.message)]
    for w in caught:
        # the capturable Adam's note that it ran uncaptured (this step is
        # meant to), and the waits where the caller did not ask for them
        if ("capturable=True" not in str(w.message)
                and (before or w not in waits)):
            warnings.warn_explicit(w.message, w.category, w.filename,
                                   w.lineno)
    if waits:
        return state, f"the step waits for the card: {waits[0].message}"
    if not state["loss"].requires_grad:
        return state, "the loss reaches no leaf"
    return state, None


def train_step(params: dict, optimizer, loss_fn, frame: int):
    """One Adam step and projection, in place; returns the loss before
    the step. A leaf the loss does not reach gets a zero gradient, as in
    JAX, so every Adam moment decays each step as optax's does (with one
    bounce and hard edges, say, the image does not depend on vertices).

    On a card, the first step of a (loss_fn, optimizer, hyperparameters,
    leaves) key runs eagerly and decides: where every render_pixels call
    of its loss and every leaf is on the one card, each call's
    graphed.forward_reason is None and the step made the host wait for
    nothing, the next step captures the step (_StepGraphs) and every
    later step of the key replays it: one graph launch a span, and the
    same stages as the eager step, so the same numbers bit for bit. A
    new key frees the card's graphs. Elsewhere, and where the warm-up
    found a reason (step_reason), every step runs eagerly.
    Spans: drt.step around the call, drt.step.forward, .backward (the
    drt.bwd.loss and drt.bwd.b{i} chain inside, where eager), .adam and
    .project; counters, while spans are on: drt.step.replayed (steps
    replayed), drt.graph.replays, and the K4 lane counts of a replay."""
    leaves = param_leaves(params)
    with profiling.span("drt.step"):
        dev, _ = _card(leaves)
        got = _STEPS.get(dev) if dev is not None else None
        if got is not None and not got.matches(leaves, optimizer, loss_fn):
            torch.cuda.synchronize(dev)
            del _STEPS[dev]
            got = None
        if isinstance(got, _Decided) and got.reason is None:
            graphs = _StepGraphs(got, params, optimizer, loss_fn, dev)
            if graphs.ok:
                _STEPS[dev] = got = graphs
            else:  # another forward than the warm-up's: warm up anew
                torch.cuda.synchronize(dev)
                del _STEPS[dev], graphs
                got = None
        if isinstance(got, _StepGraphs):
            return got.step(frame)
        optimizer.zero_grad(set_to_none=True)
        record = graphed.ForwardRecord()
        stages = _step_stages(params, optimizer, loss_fn, frame, record)
        if dev is None or got is not None:
            state = _run_eager(stages)
        else:
            state, reason = _warm_up(stages)
            _STEPS[dev] = _Decided(_StepKey(leaves, optimizer, loss_fn),
                                   record.reason(dev) or reason,
                                   record.settings())
        return state["loss"].detach()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False (pass --cpu "
                           "to run on the CPU)")
    device = torch.device("cpu" if args.cpu else "cuda")

    os.makedirs(args.out, exist_ok=True)
    w, h = (int(x) for x in args.size.split("x"))
    mesh = None
    if args.devices > 0:
        if (w * h) % args.devices:
            raise SystemExit(f"pixels ({w * h}) must divide --devices")
        mesh = make_render_mesh(
            args.devices,
            devices=[device] * args.devices if args.cpu else None)
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
                           settings=settings, mesh=mesh)
    history = []
    kinds = ("drt.launch.k1", "drt.launch.k1_emit")
    launches0 = profiling.counters("drt.launch.")
    t0 = time.perf_counter()
    with (profiling.trace(args.trace) if args.trace
          else contextlib.nullcontext()):
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
    launches1 = profiling.counters("drt.launch.")
    launches = [launches1.get(k, 0) - launches0.get(k, 0) for k in kinds]

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
