"""The hand-written CUDA kernels against their PyTorch twins on the card,
bit for bit, on chip_smoke.py's seeded 2,048-triangle soup at K = 32 with
duplicated triangles (exact t ties inside a cluster and across two): K1
(csrc/traverse_sweep.cu) in its plain, any-hit, emit_attrs and counters
calls, K2 (csrc/traverse_pallas.cu) in both node-table instances, closest
and any-hit, K3 (csrc/add_salt.cu) through the build-cache tool's child,
and K4 (csrc/rows_grad.cu, the row fetch's backward) against its twin at
the bench step's shapes, two launches bit for bit; and the bench step
itself twice, loss and gradients bit for bit, with each shading fetch.
chip_smoke.py keeps its own checks (phases 3, 3t, 3p, 10, 27, 28)."""

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


# K4 at the bench step's shapes: 262,144 lanes into the material table and
# the bench sphere's triangle table (~40% of the lanes on row 0, as the
# clamped miss lanes), and into a 256x256 float texel stack
ROW_LANES = 262_144


@pytest.mark.parametrize("n_rows,cols", [(2, 11), (16130, 19), (65536, 4)],
                         ids=["material", "triangles", "texels"])
def test_rows_grad_kernel_matches_twin(n_rows, cols):
    from dustraytracer_tpu_torch.ops import rows

    rng = np.random.default_rng(n_rows)
    if n_rows == 65536:
        idx = rng.integers(0, n_rows, ROW_LANES)
    else:
        idx = np.where(rng.uniform(size=ROW_LANES) < 0.4, 0,
                       rng.integers(0, n_rows, ROW_LANES))
    idx = torch.from_numpy(idx).to("cuda")
    grad = torch.from_numpy(rng.normal(size=(ROW_LANES, cols))
                            .astype(np.float32)).to("cuda")
    before = rows.LAUNCHES
    got = rows.rows_grad(grad, idx, n_rows)
    again = rows.rows_grad(grad, idx, n_rows)
    torch.cuda.synchronize()
    assert rows.LAUNCHES == before + 2
    assert torch.equal(got, again)
    # the tests' gradient tolerance: atol 2e-4 max|g|, rtol 2e-3
    for ref in (rows.rows_grad_reference(grad, idx, n_rows),
                rows.rows_grad_reference(grad.double(), idx, n_rows)):
        ref = ref.double()
        bound = 2e-4 * float(ref.abs().max()) + 2e-3 * ref.abs()
        assert bool(((got.double() - ref).abs() <= bound).all())


@pytest.fixture(scope="module")
def bench_sphere():
    from dustraytracer_tpu_torch.scene.camera import make_camera
    from dustraytracer_tpu_torch.scene.scene import build_scene
    from dustraytracer_tpu_torch.scene.settings import (LightParams,
                                                        RenderSettings)
    from dustraytracer_tpu_torch.tools.grad_bench import POSE, sphere_doc

    settings = RenderSettings(bounces=4, enable_tonemap=False,
                              enable_gamma=False)
    return (build_scene(sphere_doc()).to("cuda"),
            make_camera(**POSE, device="cuda"),
            LightParams.from_settings(settings, device="cuda"), settings)


@pytest.mark.parametrize("fetch", ["kernel", "gather"])
def test_bench_step_repeats_bit_for_bit(bench_sphere, fetch):
    """The 512x512 b4 bench step twice on the same inputs: the loss and
    every gradient equal bit for bit (no float atomics in the backward)."""
    from dustraytracer_tpu_torch.tools.grad_bench import repeat_check

    scene, camera, lights, settings = bench_sphere
    rec = repeat_check(scene, camera, lights,
                       settings.replace(shade_fetch=fetch))
    assert rec["loss_equal"], rec
    assert all(g["equal"] for g in rec["grads"].values()), rec["grads"]
