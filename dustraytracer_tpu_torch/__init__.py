"""dustraytracer_tpu_torch — the PyTorch / CUDA port of the JAX package
`dustraytracer_tpu`.

A second package beside the JAX one, held against it module for module
(same paths, same function names, same array layouts). It imports torch
and numpy only. The forward progressive render in reference shading and
its gradients run end to end: glTF ingest -> BVH + cluster tables ->
camera rays -> per bounce: traversal (the min-sweep cluster-BVH walk, a
hand-written CUDA kernel on the GPU, `ops/traverse_sweep.py`, behind a
ray sort; or brute force, the lockstep cluster walk or the gather walk,
with alpha cutout), shading, sun NEE any-hit, diffuse bounce -> tonemap
+ gamma -> progressive film.

On CPU tensors every kernel wrapper runs its plain PyTorch twin; on CUDA
tensors it launches the kernel or raises.
"""

__version__ = "0.1.0"

from dustraytracer_tpu_torch.scene.settings import (DebugMode, RenderMode,
                                                    RenderSettings)

__all__ = ["RenderSettings", "RenderMode", "DebugMode", "__version__"]
