from dustraytracer_tpu_torch.render.film import (Film, film_add, film_image,
                                                 film_init,
                                                 render_progressive)
from dustraytracer_tpu_torch.render.integrator import (render_pixels,
                                                       render_sample,
                                                       shade_hits)
from dustraytracer_tpu_torch.render.texture import sample_texture

__all__ = [
    "render_pixels", "render_sample", "shade_hits",
    "Film", "film_init", "film_add", "film_image", "render_progressive",
    "sample_texture",
]
