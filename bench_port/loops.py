"""The closed loops a traffic mix drives, by the name in its "loop" key.

`loop_type` finds a loop by that name: the built-in `render` and `train`
first, else `<data>/loop_types/<name>.py`, whose `LOOP` is a subclass of
`Loop`. So a deployment that needs a loop of its own brings it as a new
file. Each loop builds the program's state in `setup`, runs one unit of
work (a viewer frame, an optimizer step) per `unit()` call ending in a
host wait for its result, keeps the answers that the check compares,
frees the program's state in `release`, and computes the compared
numbers with the plain reference in a given dtype (float32; bfloat16 is
the control)."""

from __future__ import annotations

import contextlib
import math
import time
from pathlib import Path

import numpy as np
import torch

from bench_port import arith, compare, scenes
from bench_port.reference import path as ref
from bench_port.trace import span, waits_on

LIGHT_KEYS = ref.LIGHT_KEYS


def _seed_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 63, stream])


class Loop:
    """The base of every loop; the harness and control.py call only this.

    Class attributes:
      unit_name  "frame" or "step": the traced slices' unit, which picks
                 the profiled and host-wait slices' lengths (harness.py)
      chips      the card counts a cell of this loop may ask for; the
                 files test holds each cell's `chips` to it

    Methods, in the order of a run:
      setup()              build the program's state from the seed and
                           warm up every shape through the window's own
                           call: the set-up time
      unit()               one timed unit, ending in a host wait
      finish()             complete the unit in flight after the window
      answers()            what the timed path produced, to be compared
      release()            free the program's state before the reference
      reference(dtype, ...)  the plain reference's answers in `dtype`;
                           control.py passes `views` to a loop with
                           `control_views`, `half_batch=True` for a fault
      numbers(got, want)   the compared numbers, by the cell's limit names
      e2e(times, window_s) the end-to-end metrics of the window's units
    Optional:
      spans()              host-clock spans added to the traced record
      control_views()      the views the control renders (a loop with it
                           is a render loop to control.py)
      memory_peak_bytes()  the peak of the fullest card, where the loop's
                           work runs outside the harness's process
    Attributes the traced record reads: width, height, bounces, soup,
    traffic (its "loop"), and counting, which the harness sets while it
    counts host waits."""

    unit_name: str
    chips = (1,)

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 trace: bool = False, *, data: Path):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.dev = torch.device(device)
        self.trace = trace
        self.counting = False  # host waits reported around program calls
        self.width, self.height = cfg["width"], cfg["height"]
        self.bounces = cfg["bounces"]
        self.soup = scenes.make(cfg["scene"], seed, data)

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _program(self, name: str):
        """Span of a call into the program: profiler span where tracing,
        sync reports where counting host waits."""
        stack = contextlib.ExitStack()
        stack.enter_context(span(name, self.trace))
        if self.counting:
            stack.enter_context(waits_on())
        return stack

    def _build_scene(self):
        from dustraytracer_tpu_torch.scene.scene import build_scene

        return build_scene(scenes.to_document(self.soup)).to(self.dev)

    def _settings(self, **kw):
        from dustraytracer_tpu_torch.scene.settings import RenderSettings

        lights = self.cfg["lights"]
        return RenderSettings(
            bounces=self.bounces,
            sun_azimuth=lights["sun_azimuth"],
            sun_elevation=lights["sun_elevation"],
            sun_color=tuple(lights["sun_color"]),
            sun_intensity=lights["sun_intensity"],
            sky_color=tuple(lights["sky_color"]),
            sky_intensity=lights["sky_intensity"], **kw)

    def _ref_scene(self, dtype):
        return ref.RefScene(self.soup, self.dev, dtype)

    def _true_albedo(self):
        return np.float32([m["base_color"] for m in self.soup["materials"]])

    def _ref_lights(self, dtype):
        return {k: torch.tensor(np.float32(self.cfg["lights"][k]),
                                device=self.dev).to(dtype)
                for k in LIGHT_KEYS}


class RenderLoop(Loop):
    """The interactive viewer: views on an orbit around the look-at point
    drawn from the seed; each view resets the film and makes its camera
    in its first frame; a frame is one render_progressive(spp=1) call,
    film_image and a synchronize. Complete views enter a reservoir of
    `check.views`, drawn from the seed; each kept view's film image is
    compared at `check.pixels_per_view` pixels drawn from the seed."""

    unit_name = "frame"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        pose = self.cfg["camera"]
        self.look = np.float64(pose["look_at"])
        self.dist = float(np.linalg.norm(np.float64(pose["position"])
                                         - self.look))
        self.spp = self.traffic["spp_per_view"]

    def setup(self):
        from dustraytracer_tpu_torch.render.film import (film_image,
                                                         render_progressive)
        from dustraytracer_tpu_torch.scene.camera import make_camera

        self._film_image, self._render = film_image, render_progressive
        self._make_camera = make_camera
        self.scene = self._build_scene()
        self.settings = self._settings()
        self.views = _seed_rng(self.seed, 0)
        self.keep_rng = _seed_rng(self.seed, 1)
        self.kept, self.done_views = [], 0
        self.in_view, self.film, self.cam, self.view = 0, None, None, None
        # warm-up: whole views through the window's own calls
        for _ in range(self.traffic["warmup_views"] * self.spp):
            self.unit()
        self.kept, self.done_views = [], 0

    def _next_view(self) -> dict:
        t = self.traffic
        az = math.radians(self.views.uniform(*t["azimuth_deg"]))
        el = math.radians(self.views.uniform(*t["elevation_deg"]))
        off = self.dist * np.float64([math.cos(el) * math.sin(az),
                                      math.sin(el),
                                      math.cos(el) * math.cos(az)])
        return {"position": np.float32(self.look + off).tolist(),
                "look_at": np.float32(self.look).tolist(),
                "vfov_deg": float(self.cfg["camera"]["vfov_deg"]),
                "focus_dist": float(self.cfg["camera"]["focus_dist"])}

    def unit(self):
        if self.in_view == 0:
            with span("view", self.trace):
                self.view = self._next_view()
                self.cam = self._make_camera(
                    position=self.view["position"],
                    look_at=self.view["look_at"],
                    vfov_deg=self.view["vfov_deg"],
                    focus_dist=self.view["focus_dist"],
                    exposure=self.cfg["camera"]["exposure"], device=self.dev)
                self.film = None
        with self._program("render"):
            self.film = self._render(self.scene, self.cam, self.settings,
                                     width=self.width, height=self.height,
                                     spp=1, film=self.film)
        with self._program("image"):
            img = self._film_image(self.film)
        with span("sync", self.trace):
            self._sync()
        self.in_view += 1
        if self.in_view == self.spp:
            self._keep(img)
            self.in_view = 0

    def finish(self):
        """Complete the view in flight, after the window: its answer is
        late, not lost."""
        while self.in_view:
            self.unit()

    def _keep(self, img):
        """Reservoir sampling of complete views."""
        cap = self.traffic["check"]["views"]
        k = self.done_views
        self.done_views += 1
        if k < cap:
            self.kept.append((self.view, img))
            return
        j = int(self.keep_rng.integers(0, k + 1))
        if j < cap:
            self.kept[j] = (self.view, img)

    def rays_per_unit(self) -> int:
        return arith.rays(self.width, self.height, self.bounces)

    def release(self):
        self.kept = [(v, None) for v, _ in self.kept]
        self.scene = self.film = self.cam = None

    def pixels(self, n_views: int) -> list:
        """The check pixels of each of the first n_views kept views."""
        rng = _seed_rng(self.seed, 2)
        n = self.traffic["check"]["pixels_per_view"]
        return [torch.as_tensor(rng.choice(self.width * self.height, n,
                                           replace=False), device=self.dev)
                for _ in range(n_views)]

    def control_views(self) -> list:
        """The first `check.views` views of the seed's orbit, which the
        control renders in the program's place."""
        self.views = _seed_rng(self.seed, 0)
        return [self._next_view()
                for _ in range(self.traffic["check"]["views"])]

    def reference(self, dtype, views=None) -> list:
        """The reference's film at the check pixels of each kept view (or
        of `views`), in `dtype`."""
        views = views if views is not None else [v for v, _ in self.kept]
        rs = self._ref_scene(dtype)
        alb = torch.as_tensor(self._true_albedo(), device=self.dev).to(dtype)
        lights = self._ref_lights(dtype)
        out = []
        with torch.no_grad():
            for view, px in zip(views, self.pixels(len(views))):
                out.append(ref.film_pixels(
                    rs, view, alb, lights, px, self.spp, width=self.width,
                    height=self.height, bounces=self.bounces, tonemap=True,
                    gamma=True, exposure=self.cfg["camera"]["exposure"]))
        return out

    def answers(self) -> list:
        return [img.reshape(-1, 3)[px] for (_, img), px in
                zip(self.kept, self.pixels(len(self.kept)))]

    def numbers(self, got: list, want: list) -> dict:
        if not got:
            raise RuntimeError("no complete view to compare")
        return compare.pixel_numbers(torch.cat(got), torch.cat(want))

    def e2e(self, times: list, window_s: float) -> dict:
        return {"render_mrays_per_s":
                len(times) * self.rays_per_unit() / window_s / 1e6,
                "render_frame_ms_p95": arith.percentile(times, 95) * 1e3}


class TrainLoop(Loop):
    """apps/optimize.py's self-test: a target rendered at the true
    parameters (frame `target_frame`), the albedo and the lights
    scrambled from the seed, Adam through make_optimizer, and
    train_step(params, optimizer, loss_fn, frame) with frame = step %
    `frame_period`, each step's loss read on the host. Set-up drives the
    first `check_steps` steps through the same call: their losses, the
    first gradient as Adam holds it and the parameters after them are
    answers compared. So are `window_checks` steps after them, drawn
    from the seed as a reservoir: the leaves a kept step starts from
    (copied on the device before it) and the loss it read."""

    unit_name = "step"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.init = self._scramble()
        self.kept, self.seen = [], None  # seen: window steps, None in set-up

    def setup(self):
        from dustraytracer_tpu_torch.apps.optimize import (as_leaves,
                                                           make_loss_fn,
                                                           make_optimizer,
                                                           train_step)
        from dustraytracer_tpu_torch.render.integrator import render_sample
        from dustraytracer_tpu_torch.scene.camera import make_camera
        from dustraytracer_tpu_torch.scene.settings import LightParams

        t = self.traffic
        self._train_step = train_step
        self.scene = self._build_scene()
        self.settings = self._settings(**t["settings"])
        pose = self.cfg["camera"]
        self.cam = make_camera(position=pose["position"],
                               look_at=pose["look_at"],
                               vfov_deg=pose["vfov_deg"],
                               focus_dist=pose["focus_dist"],
                               exposure=pose["exposure"], device=self.dev)
        true_lights = LightParams.from_settings(self.settings,
                                                device=self.dev)
        with torch.inference_mode():
            target = render_sample(self.scene, self.cam, true_lights,
                                   t["target_frame"], width=self.width,
                                   height=self.height,
                                   settings=self.settings)
        target = target.clone()
        params = {"mat_albedo": torch.tensor(self.init["mat_albedo"],
                                             device=self.dev),
                  "lights": LightParams(**{
                      k: torch.tensor(self.init[f"lights.{k}"],
                                      device=self.dev)
                      for k in LIGHT_KEYS})}
        self.params = as_leaves(params)
        self.leaves = {"mat_albedo": self.params["mat_albedo"],
                       **{f"lights.{k}": getattr(self.params["lights"], k)
                          for k in LIGHT_KEYS}}
        self.opt = make_optimizer(self.params, t["lr"])
        base = make_loss_fn(self.scene, self.cam, true_lights, target,
                            width=self.width, height=self.height,
                            settings=self.settings)
        self.fwd_s, self.step_s = [], []
        self.loss_fn = self._timed(base) if self.trace else base
        self.step, self.losses = 0, []
        self.keep_rng = _seed_rng(self.seed, 4)
        b1 = self.opt.param_groups[0]["betas"][0]
        for s in range(t["check_steps"]):
            self.losses.append(self.unit())
            if s == 0:
                self.grad0 = {k: self.opt.state[p]["exp_avg"].detach()
                              .double().cpu() / (1.0 - b1)
                              for k, p in self.leaves.items()}
        self.after = {k: p.detach().double().cpu()
                      for k, p in self.leaves.items()}
        self.fwd_s, self.step_s = [], []
        self.seen = 0

    def _scramble(self) -> dict:
        """Initial leaves from the seed: albedo 0.5 true + 0.25 U(0, 1)
        (optimize.py's scramble), each light value true (1 + s U(-1, 1))
        with s = `scramble.lights`."""
        rng = _seed_rng(self.seed, 3)
        alb = self._true_albedo()
        out = {"mat_albedo": np.float32(
            alb * 0.5 + 0.25 * rng.uniform(size=alb.shape))}
        s = self.traffic["scramble"]["lights"]
        for k in LIGHT_KEYS:
            v = np.float32(self.cfg["lights"][k])
            out[f"lights.{k}"] = np.float32(
                v * (1.0 + s * rng.uniform(-1.0, 1.0, size=v.shape)))
        return out

    def _timed(self, base):
        def loss_fn(params, frame):
            t0 = time.perf_counter()
            with span("forward", self.trace):
                out = base(params, frame)
            self.fwd_s.append(time.perf_counter() - t0)
            return out

        return loss_fn

    def unit(self):
        t0 = time.perf_counter()
        frame = self.step % self.traffic["frame_period"]
        slot = self._slot()
        if slot is not None:
            start = {k: p.detach().clone() for k, p in self.leaves.items()}
        with self._program("train_step"):
            loss = self._train_step(self.params, self.opt, self.loss_fn,
                                    frame)
        self.step_s.append(time.perf_counter() - t0)
        with span("read", self.trace):
            val = float(loss)
        if slot is not None:
            kept = (start, frame, val)
            if slot < len(self.kept):
                self.kept[slot] = kept
            else:
                self.kept.append(kept)
        self.step += 1
        return val

    def _slot(self):
        """Reservoir slot of a window step, or None: drawn before the
        step, so that only a kept step copies its leaves."""
        if self.seen is None:
            return None
        k, cap = self.seen, self.traffic["window_checks"]
        self.seen += 1
        if k < cap:
            return k
        j = int(self.keep_rng.integers(0, k + 1))
        return j if j < cap else None

    def rays_per_unit(self) -> int:
        return arith.rays(self.width, self.height, self.bounces)

    def finish(self):
        pass

    def release(self):
        self.scene = self.params = self.opt = self.loss_fn = None
        self.leaves = None

    def answers(self) -> dict:
        window = [val for _, _, val in self.kept]
        return {"losses": self.losses + window, "grad0": self.grad0,
                "delta": {k: self.after[k] - torch.as_tensor(
                    np.float64(self.init[k])) for k in self.after}}

    def reference(self, dtype, half_batch: bool = False) -> dict:
        t = self.traffic
        cam = dict(self.cfg["camera"])
        true = {"mat_albedo": self._true_albedo(),
                **{f"lights.{k}": np.float32(self.cfg["lights"][k])
                   for k in LIGHT_KEYS}}
        rs = self._ref_scene(dtype)
        out = ref.train(
            rs, cam, self.init, true,
            steps=t["check_steps"],
            frames=[s % t["frame_period"] for s in range(t["check_steps"])],
            lr=t["lr"], width=self.width, height=self.height,
            bounces=self.bounces, target_frame=t["target_frame"],
            bounds={"mat_albedo": (0.0, 1.0)}, half_batch=half_batch)
        points = [({k: v.double().cpu() for k, v in start.items()}, frame)
                  for start, frame, _ in self.kept]
        window = ref.losses_at(
            rs, cam, points, true, width=self.width,
            height=self.height, bounces=self.bounces,
            target_frame=t["target_frame"]) if points else []
        return {"losses": out["losses"] + window,
                "grad0": {k: v.double().cpu() for k, v in
                          out["grad0"].items()},
                "delta": {k: v.double().cpu() - torch.as_tensor(
                    np.float64(self.init[k]))
                    for k, v in out["params"].items()}}

    def numbers(self, got: dict, want: dict) -> dict:
        return compare.train_numbers(got, want)

    def e2e(self, times: list, window_s: float) -> dict:
        return {"train_mrays_per_s":
                len(times) * self.rays_per_unit() / window_s / 1e6,
                "train_step_ms_p95": arith.percentile(times, 95) * 1e3}

    def spans(self) -> dict:
        return {"fwd_s": list(self.fwd_s), "step_s": list(self.step_s)}


LOOPS = {"render": RenderLoop, "train": TrainLoop}


def loop_type(name: str, data: Path) -> type:
    """The loop class of a traffic mix's "loop": a built-in, or the `LOOP`
    of `<data>/loop_types/<name>.py`."""
    if name in LOOPS:
        return LOOPS[name]
    cls = scenes.from_file(data, "loop_types", name, "LOOP")
    if not (isinstance(cls, type) and issubclass(cls, Loop)):
        raise TypeError(f"{data / 'loop_types' / name}.py: LOOP is not a "
                        f"subclass of bench_port.loops.Loop")
    return cls
