"""The forward sample replayed as CUDA graphs.

An eager sample launches about 120 PyTorch kernels a bounce for the
shading alone, each from the host. Here the stages of
integrator.sample_stages (drt.raygen, each bounce's trace, shade, NEE
and scatter, drt.post) are each captured once into a
torch.cuda.CUDAGraph and replayed inside their spans: one graph launch
a stage. The same stage functions run eagerly everywhere else, so the
replayed sample equals the eager one bit for bit.

- `eager_reason(...)`: why a sample stays eager (None where it replays):
  a device other than CUDA, grad on (autograd records the eager ops),
  DEBUG mode, a traversal or option that reads a result on the host
  (SYNCING), or a camera or lights not float32 on the scene's device.
  `forward_reason(...)` is the same without the grad rule: why a sample
  cannot be captured at all, which the train step (apps/optimize.py)
  asks of each render_pixels call in its loss through a ForwardRecord.
- `runner(...)`: the graphs for the scene, size, settings and tile (a
  range of global pixel ids, the whole image by default), captured on
  first use after one eager warm-up sample, on the scene's card and its
  side stream, all in one memory pool and in replay order. The inputs
  are static buffers: the camera's and the lights' fields, refreshed by
  one device copy before each sample, and the frame index, written by a
  fill. Runners are keyed by (card, tile), so a mesh that names one card
  several times keeps one runner per tile. A new key (scene, size,
  settings, input shapes) frees the card's graphs of every tile it
  overlaps. A capture that fails raises.
- Counters (utils/profiling.py): `drt.graph.captures` (graphs captured,
  always), `drt.graph.replays` (graphs replayed, while spans are on, as
  the K4 lane counts, so that a reader divides it by the same slice's
  drt.frame spans); each replay adds its graph's capture-time
  `drt.launch.*` counts, so the launch counters count the kernels that
  run.
- `capture(stages, dev)` and `replay(graphs, load)`: the capture and
  the replay themselves, which the train step shares.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch

from dustraytracer_tpu_torch.render.integrator import (_check_settings,
                                                       _resolve_fetch,
                                                       sample_stages,
                                                       tracer_kind)
from dustraytracer_tpu_torch.scene.camera import Camera
from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                    RenderMode,
                                                    RenderSettings)
from dustraytracer_tpu_torch.utils import profiling

# options whose sample makes the host wait for the card (a nonzero or a
# boolean mask, whose size the host reads), which a capture cannot hold
SYNCING = {
    "traversal=cluster": "the cluster walk compacts its frontier with "
                         "nonzero",
    "traversal=gather": "the gather walk compacts its frontier with "
                        "nonzero",
    "alpha_test": "the alpha re-trace selects its rays by boolean masks",
}
_RUNNERS = {}  # (device, first pixel id, last + 1) -> _Runner


def _fields(camera: Camera, lights: LightParams) -> list:
    return ([getattr(camera, f.name) for f in dataclasses.fields(camera)]
            + [getattr(lights, f.name) for f in dataclasses.fields(lights)])


def eager_reason(scene, camera: Camera, lights: LightParams,
                 settings: RenderSettings) -> str | None:
    """Why film_accumulate renders this sample eagerly, or None where it
    replays graphs."""
    if scene.device.type == "cuda" and torch.is_grad_enabled():
        return "grad is on: autograd records the eager ops"
    return forward_reason(scene, camera, lights, settings)


def forward_reason(scene, camera: Camera, lights: LightParams,
                   settings: RenderSettings) -> str | None:
    """Why this sample cannot be captured, with grad on or off, or None
    where it can."""
    dev = scene.device
    if dev.type != "cuda":
        return f"device {dev} is not CUDA"
    if settings.render_mode != RenderMode.NORMAL:
        return "DEBUG mode"
    kind = tracer_kind(scene, settings)
    if f"traversal={kind}" in SYNCING:
        return SYNCING[f"traversal={kind}"]
    if settings.alpha_test:
        return SYNCING["alpha_test"]
    if any(t.dtype != torch.float32 or t.device != dev
           for t in _fields(camera, lights)):
        return "a camera or lights field is not float32 on the device"
    return None


class ForwardRecord:
    """What a loss's forward reports inside integrator.reporting_to: each
    render_pixels call's forward_reason, card and settings; and, where
    `capturing`, the lanes of each material fetch and its live-lane sum,
    a device scalar that the forward's graph writes (the K4 counters of
    a replay, which runs no Python)."""

    def __init__(self, capturing: bool = False):
        self.capturing = capturing
        self.calls = []     # (forward_reason, card, settings) per call
        self.n_lanes = 0
        self.live = []

    def call(self, scene, camera, lights, settings) -> None:
        self.calls.append((forward_reason(scene, camera, lights, settings),
                           scene.device, settings))

    def lanes(self, live_hit: torch.Tensor) -> None:
        if self.capturing:
            self.n_lanes += live_hit.shape[0]
            self.live.append(live_hit.sum())

    def settings(self) -> list:
        return [st for _, _, st in self.calls]

    def reason(self, dev) -> str | None:
        """Why the recorded forward cannot be captured on card `dev`, or
        None where it can."""
        if not self.calls:
            return "the loss calls no render_pixels"
        cards = {str(d) for _, d, _ in self.calls} | {str(dev)}
        if len(cards) > 1:
            return (f"render_pixels calls and leaves on {sorted(cards)}: "
                    f"not one card")
        return next((r for r, _, _ in self.calls if r is not None), None)


def _fingerprint(scene) -> tuple:
    """The addresses and shapes of the scene's tensors, which the graphs
    read, and its cluster tables' identity."""
    return (id(scene.cluster),) + tuple(
        (v.data_ptr(), v.shape) for v in vars(scene).values()
        if isinstance(v, torch.Tensor))


class StaticInputs:
    """A sample's inputs at fixed addresses: the camera's and the lights'
    fields as views of one float32 buffer, and the frame index as a 0-d
    int64 tensor. `load` refreshes them on the device: one copy and one
    fill, no host wait."""

    def __init__(self, camera: Camera, lights: LightParams, dev):
        fields = _fields(camera, lights)
        self.flat = torch.empty((sum(t.numel() for t in fields),),
                                dtype=torch.float32, device=dev)
        views, at = [], 0
        for t in fields:
            views.append(self.flat[at:at + t.numel()].view(t.shape))
            at += t.numel()
        n_cam = len(dataclasses.fields(Camera))
        self.camera = Camera(*views[:n_cam])
        self.lights = LightParams(*views[n_cam:])
        self.frame = torch.zeros((), dtype=torch.int64, device=dev)

    def load(self, camera: Camera, lights: LightParams, frame: int) -> None:
        torch.cat([t.reshape(-1) for t in _fields(camera, lights)],
                  out=self.flat)
        self.frame.fill_(frame)


def on_card(dev):
    """torch.cuda.device(dev) on a card, nothing elsewhere: a graph
    replays on the current card's current stream."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class _Runner:
    """The captured graphs of one (scene, size, settings, input shapes)
    over the global pixel ids tile[0] ... tile[1] - 1."""

    def __init__(self, scene, camera, lights, *, width, height, settings,
                 shapes, tile):
        dev = self.dev = scene.device
        self.scene = weakref.ref(scene)
        self.fingerprint = _fingerprint(scene)
        self.key = (width, height, settings, shapes)
        with torch.cuda.device(dev):
            # every tensor made outside the capture that the graphs read
            # lives as long as they do: the inputs and the pixel ids
            self.inputs = StaticInputs(camera, lights, dev)
            self.pixel_ids = torch.arange(*tile, dtype=torch.int64,
                                          device=dev)
            # the K4 live-lane count is left out: the forward never runs
            # K4
            stages = sample_stages(
                scene, self.inputs.camera, self.inputs.lights,
                self.inputs.frame, self.pixel_ids, width=width,
                height=height, count_lanes=False,
                settings=settings.replace(
                    shade_fetch=_resolve_fetch(scene, settings)))
            self.inputs.load(camera, lights, 0)
            state = None  # warm-up: builds the kernels and the tables
            for _, stage in stages:
                state = stage(state)
            del state
            self.graphs, out = capture(stages, dev)
        self.out = out["light"]

    def matches(self, scene, width, height, settings, shapes) -> bool:
        return (self.scene() is scene
                and self.key == (width, height, settings, shapes)
                and self.fingerprint == _fingerprint(scene))

    def sample(self, camera, lights, frame: int,
               timer: str | None = None) -> torch.Tensor:
        """Sample `frame` of the tile: the static (n, 3) output, which the
        next replay overwrites. Spans as the eager sample's. Call it with
        the runner's card current (on_card). `timer`: the name of a
        profiling.device_timer around each stage (its input load and one
        graph launch), so no wait for the host's next launch is timed."""
        with profiling.span("drt.sample"):
            replay(self.graphs,
                   lambda: self.inputs.load(camera, lights, frame),
                   timer, self.dev)
        return self.out


def replay(graphs, load, timer: str | None = None, dev=None) -> None:
    """Replay `capture`'s graphs in order, each inside its span (and the
    device timer `timer` on `dev`), after `load()` refreshes the first
    graph's static inputs; each adds its capture-time `drt.launch.*`
    counts, and, while spans are on, drt.graph.replays the graphs."""
    for i, (name, graph, launched) in enumerate(graphs):
        with profiling.span(name), profiling.device_timer(timer, dev):
            if i == 0:
                load()
            graph.replay()
        for key, n in launched:
            profiling.count(key, n)
    if profiling.enabled():
        profiling.count("drt.graph.replays", len(graphs))


def capture(stages, dev) -> tuple:
    """Capture each stage into its own graph, in order, in one pool, on a
    side stream; returns ([(span name, graph, launch counts)], the last
    stage's state). Call it with spans off or muted: a span's hook or
    count would be baked into the graph."""
    pool = torch.cuda.graph_pool_handle()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graphs, state = [], None
    with torch.cuda.stream(side):
        for name, stage in stages:
            graph = torch.cuda.CUDAGraph()
            before = profiling.host_counters("drt.launch.")
            # thread_local: another thread's sync (the viewer's HTTP
            # threads) cannot break this capture
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                state = stage(state)
            finally:
                graph.capture_end()
            launched = tuple(
                (k, n - before.get(k, 0)) for k, n in
                profiling.host_counters("drt.launch.").items()
                if n != before.get(k, 0))
            # captured, not run: each replay counts them
            for key, n in launched:
                profiling.count(key, -n)
            graphs.append((name, graph, launched))
            profiling.count("drt.graph.captures")
    torch.cuda.current_stream(dev).wait_stream(side)
    return graphs, state


def runner(scene, camera: Camera, lights: LightParams, *, width: int,
           height: int, settings: RenderSettings, tile=None):
    """The graph runner of this sample over the global pixel ids
    tile[0] ... tile[1] - 1 (default: the whole image), captured where it
    is new, or None where the sample stays eager (eager_reason)."""
    _check_settings(settings)
    if eager_reason(scene, camera, lights, settings) is not None:
        return None
    dev = scene.device
    start, stop = (0, width * height) if tile is None else tile
    shapes = tuple(t.shape for t in _fields(camera, lights))
    key = (dev, start, stop)
    run = _RUNNERS.get(key)
    if run is not None and run.matches(scene, width, height, settings,
                                       shapes):
        return run
    del run
    # a new key frees the card's runners over any of its pixels first
    old = [k for k in _RUNNERS if k[0] == dev and k[1] < stop
           and start < k[2]]
    if old:
        torch.cuda.synchronize(dev)
        for k in old:
            del _RUNNERS[k]
    _RUNNERS[key] = _Runner(scene, camera, lights, width=width,
                            height=height, settings=settings, shapes=shapes,
                            tile=(start, stop))
    return _RUNNERS[key]

