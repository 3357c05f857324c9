"""The inverse-rendering parameter overlay (port of parallel/shard.py's
`apply_params`). The tile-sharded render and train step, which split the
pixels over devices and all-reduce the gradients, are not ported yet."""

from __future__ import annotations


def apply_params(scene, camera, lights, params: dict):
    """Overlay optimizable parameters onto scene/camera/lights.

    Recognized keys: any Scene field (`mat_albedo`, `mat_emissive`,
    `mat_metallic`, `mat_roughness`, `mat_transmission`, `mat_ior`,
    `tri_pos`, a float `tex_stack`), `camera` (a whole Camera), `lights`
    (a whole LightParams). Scene fields go through Scene.replace, so a
    new `tri_pos` re-bakes the cluster tables and refits the BVH
    boxes."""
    scene_keys = {k: v for k, v in params.items()
                  if k not in ("camera", "lights")}
    if scene_keys:
        scene = scene.replace(**scene_keys)
    camera = params.get("camera", camera)
    lights = params.get("lights", lights)
    return scene, camera, lights
