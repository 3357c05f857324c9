from dustraytracer_tpu_torch.ops.intersect import (moller_trumbore,
                                                   ray_aabb_entry)
from dustraytracer_tpu_torch.ops.rng import (pcg_hash, random_float,
                                             random_in_ball, random_unit_vec3)
from dustraytracer_tpu_torch.ops.tonemap import (gamma_correct,
                                                 uncharted2_filmic)
from dustraytracer_tpu_torch.ops.traverse import (traverse_anyhit,
                                                  traverse_closest)
from dustraytracer_tpu_torch.ops.traverse_sweep import traverse_cluster_sweep

__all__ = [
    "ray_aabb_entry", "moller_trumbore",
    "pcg_hash", "random_float", "random_unit_vec3", "random_in_ball",
    "uncharted2_filmic", "gamma_correct",
    "traverse_closest", "traverse_anyhit", "traverse_cluster_sweep",
]
