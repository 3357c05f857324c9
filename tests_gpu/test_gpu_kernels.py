"""The hand-written CUDA kernels against their PyTorch twins on the card,
bit for bit, on chip_smoke.py's seeded 2,048-triangle soup at K = 32 with
duplicated triangles (exact t ties inside a cluster and across two): K1
(csrc/traverse_sweep.cu) in its plain, any-hit, emit_attrs and counters
calls, K2 (csrc/traverse_pallas.cu) in both node-table instances, closest
and any-hit, and K3 (csrc/add_salt.cu) through the build-cache tool's
child. chip_smoke.py keeps its own checks (phases 3, 3t, 3p, 10)."""

import numpy as np
import pytest
import torch

from chip_smoke import TIE_CALLS, tie_rays, tie_soup

pytestmark = pytest.mark.gpu
K = 32


@pytest.fixture(scope="module")
def soup():
    from dustraytracer_tpu_torch.accel.cluster import build_cluster_bvh

    pos, inside, across = tie_soup(K)
    rng = np.random.default_rng(100 + K)
    nt = pos.shape[0]
    fn = rng.normal(size=(nt, 3)).astype(np.float32)
    fn /= np.linalg.norm(fn, axis=-1, keepdims=True)
    cb = build_cluster_bvh(
        pos, k=K, uv=rng.uniform(0, 1, (nt, 3, 2)).astype(np.float32),
        face_nrm=fn, mat=rng.integers(0, 4, nt).astype(np.int32)).to("cuda")
    o, d = (torch.from_numpy(x).to("cuda")
            for x in tie_rays(pos, np.concatenate([inside, across])))
    return cb, o, d, inside


def _equal(got: dict, want: dict, what: str):
    assert got.keys() == want.keys(), what
    for key in got:
        assert torch.equal(got[key], want[key]), (
            f"{what}: {key} differs from the twin in "
            f"{int((got[key] != want[key]).sum())} entries")


@pytest.mark.parametrize("mode", list(TIE_CALLS))
def test_sweep_kernel_matches_twin(soup, mode):
    from dustraytracer_tpu_torch.ops import traverse_sweep as ts

    cb, o, d, inside = soup
    kw = TIE_CALLS[mode]
    before = ts.LAUNCHES + ts.EMIT_LAUNCHES + ts.COUNT_LAUNCHES
    got = ts.traverse_cluster_sweep(cb, o, d, **kw)
    torch.cuda.synchronize()
    assert ts.LAUNCHES + ts.EMIT_LAUNCHES + ts.COUNT_LAUNCHES == before + 1
    _equal(got, ts.traverse_cluster_sweep_reference(cb, o, d, **kw),
           f"sweep {mode}")
    if mode == "plain":  # a ray tied inside one cluster takes the lower id
        hit = got["hit_idx"].cpu().numpy()
        tied = hit[np.isin(hit, inside)]
        assert len(tied) > 0 and np.isin(tied, inside[:, 0]).all()


@pytest.mark.parametrize("anyhit", [False, True])
@pytest.mark.parametrize("instance", ["shared", "global"])
def test_pallas_kernel_matches_twin(soup, instance, anyhit):
    from dustraytracer_tpu_torch.ops import traverse_pallas as tp

    cb, o, d, _ = soup
    call = {"shared": tp.traverse_cluster_pallas,
            "global": tp.traverse_cluster_pallas_global}[instance]
    assert tp.launch_config(cb, o.shape[0])["node_table"] == "shared"
    before = tp.LAUNCHES
    got = call(cb, o, d, anyhit=anyhit)
    torch.cuda.synchronize()
    assert tp.LAUNCHES == before + 1
    _equal(got, tp.traverse_cluster_pallas_reference(cb, o, d, anyhit=anyhit),
           f"pallas {instance} anyhit={anyhit}")


def test_add_salt_kernel_matches_twin(tmp_path):
    from dustraytracer_tpu_torch.tools import repro_cache_hang as rch

    res = rch.child(rch._write_source(tmp_path, 0.3125), tmp_path)
    assert res["salt"] == 0.3125
    assert res["ok"] and res["max_abs_err"] == 0.0, res
    assert res["launches"] == 1
