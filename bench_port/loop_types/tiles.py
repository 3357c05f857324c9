"""The viewer's orbit over the four cards of one host: RenderLoop's
views, check and metrics, with every frame's pixels split over the mesh
cuda:0 ... cuda:3 (`render_progressive(mesh=...)`): tile i, a band of
rows, renders and accumulates on card i from that card's copy of the
scene, and film_image gathers the tiles onto card 0. A view's camera is
made on every card from the host's numbers, as the one-card loop makes
it on its card, so the only copies between cards in a frame are the
gather's. A frame ends in a synchronize of every card. Without a card
the mesh is the configuration's number of tiles on the loop's device."""

import torch

from bench_port.loops import RenderLoop
from bench_port.trace import span


class TilesLoop(RenderLoop):
    chips = (4,)

    def setup(self):
        from dustraytracer_tpu_torch.parallel.mesh import make_render_mesh

        n = self.cfg["cards"]
        self.mesh = (make_render_mesh(n) if self.dev.type == "cuda"
                     else [self.dev] * n)
        super().setup()

    def _build_scene(self):
        from dustraytracer_tpu_torch.parallel.mesh import replicate_scene

        return replicate_scene(super()._build_scene(), self.mesh)

    def _sync(self):
        if self.dev.type == "cuda":
            for card in dict.fromkeys(self.mesh):
                torch.cuda.synchronize(card)

    def unit(self):
        if self.in_view == 0:
            with span("view", self.trace):
                self.view = self._next_view()
                self.cam = [self._make_camera(
                    position=self.view["position"],
                    look_at=self.view["look_at"],
                    vfov_deg=self.view["vfov_deg"],
                    focus_dist=self.view["focus_dist"],
                    exposure=self.cfg["camera"]["exposure"], device=card)
                    for card in self.mesh]
                self.film = None
        with self._program("render"):
            self.film = self._render(self.scene, self.cam, self.settings,
                                     width=self.width, height=self.height,
                                     spp=1, film=self.film, mesh=self.mesh)
        with self._program("image"):
            img = self._film_image(self.film)
        with span("sync", self.trace):
            self._sync()
        self.in_view += 1
        if self.in_view == self.spp:
            self._keep(img)
            self.in_view = 0


LOOP = TilesLoop
