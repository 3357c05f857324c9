from dustraytracer_tpu_torch.accel.bvh import BvhArrays, build_bvh
from dustraytracer_tpu_torch.accel.cluster import ClusterBvh, build_cluster_bvh

__all__ = ["build_bvh", "BvhArrays", "ClusterBvh", "build_cluster_bvh"]
