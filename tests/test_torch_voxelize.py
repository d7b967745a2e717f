"""The port's device voxelizer (dal3d_tpu_torch/ops/voxelize.py) against JAX's
(dal3d_tpu/ops/voxelize.py) on the CPU.

Seeded numpy clouds, a batch of 2, with points inside and outside the grid,
non-finite x / y / z, invalid (padding) points, and a ``max_voxel_num`` small
enough that the later voxels drop. JAX's per-frame functions run under
``vmap``, as its models call them. Integer outputs (coordinates, counts,
validity, voxel order, the number of voxels) must be equal; features and the
[M, K, F] voxel tensor within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.ops import voxelize as jv
from dal3d_tpu_torch.ops import voxelize as tv
from torch_port_utils import t

FEAT_TOL = 1e-6
# a 20 m x 20 m x 4 m grid at 0.5 m: (40, 40, 8) cells
RANGE, SIZE = (-10.0, -10.0, -2.0, 10.0, 10.0, 2.0), (0.5, 0.5, 0.5)
CASES = {
    "roomy": (5, 2000),  # (max_points_in_voxel, max_voxel_num): no voxel drops
    "overflow": (3, 150),  # the later voxels drop
}
FUNCS = ("voxelize", "voxelize_mean", "voxelize_mean_grid", "scatter_mean", "scatter_max")


def make_clouds(seed=0, B=2, P=1200):
    """[B, P, 5] f32 and [B, P] validity: clustered points (several per
    voxel) inside the grid, 10 % outside it, a few with NaN / inf in x, y or
    z, and a padded tail of invalid points."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((B, P, 5), np.float32)
    valid = np.zeros((B, P), bool)
    for b in range(B):
        n = P - 100 * (b + 1)
        centres = rng.uniform(-9.5, 9.5, (60, 3)) * [1, 1, 0.19]
        p = centres[rng.randint(0, 60, n)] + rng.normal(0, 0.4, (n, 3))
        p = np.concatenate([p, rng.uniform(0, 1, (n, 2))], 1).astype(np.float32)
        k = n // 10
        p[:k, rng.randint(0, 3)] = rng.choice([-30.0, 30.0], k)  # out of the grid
        for j, v in enumerate((np.nan, np.inf, -np.inf, np.nan)):
            p[k + j, j % 3] = v
        p[k + 4, :3] = [10.0, 0.0, 0.0]  # on the upper edge: out
        p[k + 5, :3] = [-10.0, -10.0, -2.0]  # on the lower edge: in
        rng.shuffle(p)
        pts[b, :n] = p
        valid[b, :n] = True
        valid[b, rng.randint(0, n, 20)] = False  # invalid points inside the cloud
        pts[b, n:] = rng.uniform(-5, 5, (P - n, 5))  # padding: finite, in the grid
    return pts, valid


def _run_jax(name, cfg, pts, valid):
    fn = {"voxelize": jv.voxelize, "voxelize_mean": jv.voxelize_mean,
          "voxelize_mean_grid": jv.voxelize_mean_grid,
          "scatter_mean": lambda p, v, c: jv.dynamic_scatter(p, v, c, "mean"),
          "scatter_max": lambda p, v, c: jv.dynamic_scatter(p, v, c, "max")}[name]
    out = jax.jit(jax.vmap(lambda p, v: fn(p, v, cfg)))(jnp.asarray(pts), jnp.asarray(valid))
    return {k: np.asarray(v) for k, v in out.items()}


def _run_port(name, cfg, pts, valid):
    if name.startswith("scatter_"):
        out = tv.dynamic_scatter(t(pts), t(valid), cfg, name.split("_")[1])
    else:
        out = getattr(tv, name)(t(pts), t(valid), cfg)
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_outputs():
    """Every JAX voxelizer on both cases (one compile each)."""
    pts, valid = make_clouds()
    return {(case, name): _run_jax(name, jv.VoxelConfig(RANGE, SIZE, *CASES[case]), pts, valid)
            for case in CASES for name in FUNCS}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", FUNCS)
def test_matches_jax(jax_outputs, name, case):
    pts, valid = make_clouds()
    cfg = tv.VoxelConfig(RANGE, SIZE, *CASES[case])
    want = jax_outputs[(case, name)]
    got = _run_port(name, cfg, pts, valid)
    assert set(got) == set(want)
    M = cfg.max_voxel_num
    for k in ("coordinates", "num_points", "voxel_valid", "num_voxels"):
        if k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["voxel_valid"].shape == (2, M)
    n = want["num_voxels"]
    assert (n > 50).all()
    assert (n == M).all() if case == "overflow" else (n < M).all()
    feats = "voxels" if name == "voxelize" else "features"
    assert got[feats].dtype == np.float32
    scale = max(float(np.abs(want[feats]).max()), 1.0)
    np.testing.assert_allclose(got[feats], want[feats], rtol=0, atol=FEAT_TOL * scale)


def test_grid_variant_order_and_drops():
    """Ascending cells, the lowest M kept, the mean over every point of a
    voxel: against a numpy recount of one frame."""
    pts, valid = make_clouds(seed=3, B=1)
    cfg = tv.VoxelConfig(RANGE, SIZE, 4, 100)
    out = tv.voxelize_mean_grid(t(pts), t(valid), cfg)
    p = pts[0][valid[0] & np.isfinite(pts[0, :, :3]).all(1)]
    c = np.floor((p[:, :3] - np.float32(RANGE[:3])) / np.float32(SIZE)).astype(np.int64)
    keep = ((c >= 0) & (c < [40, 40, 8])).all(1)
    p, c = p[keep], c[keep]
    lin = (c[:, 2] * 40 + c[:, 1]) * 40 + c[:, 0]
    cells = np.unique(lin)[:100]
    coords = out["coordinates"][0].numpy()
    np.testing.assert_array_equal((coords[:, 0] * 40 + coords[:, 1]) * 40 + coords[:, 2], cells)
    for v in (0, 37, 99):
        sel = lin == cells[v]
        assert int(out["num_points"][0, v]) == sel.sum()
        np.testing.assert_allclose(out["features"][0, v].numpy(), p[sel].mean(0), atol=1e-5)
    # the empty slots of a roomy config: coordinates (D, 0, 0), nothing valid
    roomy = tv.voxelize_mean_grid(t(pts), t(valid), tv.VoxelConfig(RANGE, SIZE, 4, 4000))
    n = int(roomy["num_voxels"][0])
    assert not roomy["voxel_valid"][0, n:].any()
    assert (roomy["coordinates"][0, n:] == torch.tensor([8, 0, 0], dtype=torch.int32)).all()


def test_rejects_unbatched_points():
    cfg = tv.VoxelConfig(RANGE, SIZE, 4, 100)
    with pytest.raises(ValueError, match=r"\[B, P, F\]"):
        tv.voxelize_mean_grid(torch.zeros(10, 5), torch.ones(10, dtype=torch.bool), cfg)
    with pytest.raises(ValueError, match="'mean' or 'max'"):
        tv.dynamic_scatter(torch.zeros(1, 10, 5), torch.ones(1, 10, dtype=torch.bool), cfg,
                           "sum")


@pytest.mark.parametrize("sort_free", [True, False])
def test_model_voxelizes_raw_points_with_its_variant(sort_free):
    """FPNVoxelNet fed raw points voxelizes them with the grid variant, or
    with the first-arrival variant under ``sort_free_voxelize=False``."""
    from dal3d_tpu_torch.models.detectors.voxelnet import FPNVoxelNet

    pts, valid = make_clouds(seed=4)
    cfg = tv.VoxelConfig(RANGE, SIZE, 4, 300)
    model = FPNVoxelNet(cfg.sparse_shape, voxel_cfg=cfg, sort_free_voxelize=sort_free)
    vf, vc, vv = model.voxelize(t(pts), t(valid))
    want = (tv.voxelize_mean_grid if sort_free else tv.voxelize_mean)(t(pts), t(valid), cfg)
    assert torch.equal(vf, want["features"]) and torch.equal(vc, want["coordinates"])
    assert torch.equal(vv, want["voxel_valid"])
    with pytest.raises(ValueError, match="voxel_cfg"):
        FPNVoxelNet(cfg.sparse_shape).voxelize(t(pts), t(valid))
