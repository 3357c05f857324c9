"""Carry a scene across from the JAX package as numpy arrays.

`scene_from_numpy` takes the JAX `Scene`'s leaves — each dataclass field
by name, arrays as numpy, static metadata as Python values, and the
cluster tables as a nested dict under "cluster" (or None) — and returns
the port's `Scene` on the CPU. A test then hands both packages the
identical scene. `scene_to_numpy` goes the other way, from a scene of
either package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dustraytracer_tpu_torch.accel.cluster import ClusterBvh
from dustraytracer_tpu_torch.scene.scene import Scene


def _from(cls, arrays: dict, skip=()):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in skip or f.name not in arrays:
            continue
        v = arrays[f.name]
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.array(v))  # own copy, writable
        kw[f.name] = v
    return cls(**kw)


def cluster_from_numpy(arrays: dict) -> ClusterBvh:
    return _from(ClusterBvh, arrays, skip=("device_tables",))


def scene_from_numpy(arrays: dict) -> Scene:
    cl = arrays.get("cluster")
    scene = _from(Scene, arrays, skip=("cluster",))
    return dataclasses.replace(
        scene, cluster=None if cl is None else cluster_from_numpy(cl))


def _to(obj) -> dict:
    out = {}
    for f in dataclasses.fields(obj):
        if f.name == "device_tables":
            continue
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        elif dataclasses.is_dataclass(v):
            v = _to(v)
        elif hasattr(v, "__array__"):  # a JAX array
            v = np.asarray(v)
        out[f.name] = v
    return out


def scene_to_numpy(scene) -> dict:
    """The leaves of a Scene of either package as numpy arrays and Python
    values, in the layout `scene_from_numpy` takes."""
    return _to(scene)
