from dustraytracer_tpu_torch.scene.camera import Camera, make_camera
from dustraytracer_tpu_torch.scene.gltf import GltfDocument, load_gltf
from dustraytracer_tpu_torch.scene.scene import Scene, build_scene, load_scene
from dustraytracer_tpu_torch.scene.settings import (DebugMode, LightParams,
                                                    RenderMode,
                                                    RenderSettings)

__all__ = [
    "load_gltf", "GltfDocument",
    "Scene", "build_scene", "load_scene",
    "Camera", "make_camera",
    "RenderSettings", "RenderMode", "DebugMode", "LightParams",
]
