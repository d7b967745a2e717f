"""Port parity of BEVFusion's camera branch below the backbone, module by
module, on the CPU: ``ops/resize.py`` against ``jax.image.resize``,
``ops/bev_pool.py``, the frustum geometry, ``DepthLSSTransform`` /
``LSSTransform``, the LSS FPN and both fusers against the JAX package's.

Weights: flax variables shaped by ``eval_shape``, filled with seeded numpy
values, carried across by the weights bridge (models/convert_flax.py).
Required: resize within 1e-6 of its scale, bev_pool within 1e-6, the
geometry within 1e-5 of its scale with the integer cells equal except at
points within 1e-4 of a cell edge (fewer than 1e-3 of the points; the two
packages' 3x3 inverses round differently), the view transforms fed the same
cells, the FPN and the fusers within 1e-5 of their scale in eval mode, and
within 1e-4 in train mode: the batch statistics take flax's fast variance
E[x^2] - E[x]^2 in f32, whose cancellation in the two packages' summation
orders reaches 1e-5 after the depth branch's five batch norms."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.models.bevfusion import vtransforms as jvt
from dal3d_tpu.models.bevfusion.lss_fpn import GeneralizedLSSFPN as JaxFPN
from dal3d_tpu.models.bevfusion.second import AddFuser as JaxAddFuser
from dal3d_tpu.models.bevfusion.second import ConvFuser as JaxConvFuser
from dal3d_tpu.ops.bev_pool import bev_pool_batched as jax_bev_pool
from dal3d_tpu_torch.models.bevfusion import vtransforms as tvt
from dal3d_tpu_torch.models.bevfusion.lss_fpn import GeneralizedLSSFPN
from dal3d_tpu_torch.models.bevfusion.second import AddFuser, ConvFuser
from dal3d_tpu_torch.models.convert_flax import (_conv_bn, _flatten, lss_fpn_flax_to_state_dict,
                                                 vtransform_flax_to_state_dict)
from dal3d_tpu_torch.ops.bev_pool import bev_pool_batched
from dal3d_tpu_torch.ops.resize import resize_bilinear
from test_torch_bevfusion import _randomize

pytestmark = pytest.mark.usefixtures("few_threads")

TOL = 1e-5
TRAIN_TOL = 1e-4


@pytest.fixture(scope="module")
def few_threads():
    """Two intra-op threads for a module's tests (this file's and the other
    stage-2 files' that import it): the lane runs several workers side by
    side, and a full set of threads in each makes them fight for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _variables(module, seed, *args):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    return _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes),
                      np.random.RandomState(seed))


def _load(port, sd):
    port.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                         strict=True)
    return port


def _both_modes(jmod, variables, port, jargs, targs):
    """The JAX module and the port's on the same inputs, eval then train
    mode (batch statistics): returns [(port out, jax out, jax's new
    batch_stats or None, tolerance)] per mode."""
    res = []
    for train in (False, True):
        port.train(train)
        with torch.no_grad():
            got = port(*targs)
        if train:
            want, new = jmod.apply(variables, *jargs, train=True, mutable=["batch_stats"])
        else:
            want, new = jmod.apply(variables, *jargs, train=False), None
        res.append((got, want, new, TRAIN_TOL if train else TOL))
    return res


@pytest.mark.parametrize("shape,out", [((2, 8, 22, 5), (16, 44)), ((1, 180, 180, 4), (52, 52)),
                                       ((2, 37, 50, 3), (23, 80))])
def test_resize_matches_jax_image_resize(shape, out):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (shape[0], *out, shape[3]), "bilinear")
    got = resize_bilinear(torch.from_numpy(x), out)
    assert tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) <= 1e-6


def test_bev_pool_matches_jax():
    rng = np.random.RandomState(1)
    B, Np, C, nx, ny, nz = 2, 6000, 7, 20, 16, 2
    feats = rng.randn(B, Np, C).astype(np.float32)
    coords = np.stack([rng.randint(-2, nx + 2, (B, Np)), rng.randint(-2, ny + 2, (B, Np)),
                       rng.randint(-1, nz + 1, (B, Np))], -1).astype(np.int32)
    valid = np.all((coords >= 0) & (coords < np.array([nx, ny, nz])), -1)
    feats[~valid] = np.nan  # an invalid point's row never reaches a cell
    want = jax_bev_pool(jnp.asarray(np.nan_to_num(feats)), jnp.asarray(coords),
                        jnp.asarray(valid), nx, ny, nz)
    got = bev_pool_batched(torch.from_numpy(feats), torch.from_numpy(coords),
                           torch.from_numpy(valid), nx, ny, nz)
    assert tuple(got.shape) == want.shape == (B, ny, nx, nz * C)
    assert _rel(got.numpy(), want) <= 1e-6


def ring_cameras(B, N, image_hw, feat_hw, orig_hw=(900, 1600), focal=1266.0, seed=0):
    """Per-camera transforms of a ring of N cameras at the ego origin (the
    synthetic writer's extrinsics), intrinsics of an orig_hw camera, and the
    image augmentation of a resize to image_hw's width, a bottom crop, a
    flip on every other camera and a small seeded rotation (ImageAug3D's
    affine): [B, N, 3, 3] / [B, N, 3] float32 arrays."""
    rng = np.random.RandomState(seed)
    rots, K, aug_r = (np.zeros((B, N, 3, 3), np.float32) for _ in range(3))
    trans, aug_t = np.zeros((B, N, 3), np.float32), np.zeros((B, N, 3), np.float32)
    base = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    fH, fW = image_hw
    for b in range(B):
        for n in range(N):
            yaw = 2 * np.pi * n / N
            c, s = np.cos(yaw), np.sin(yaw)
            rots[b, n] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ base
            trans[b, n] = [0.0, 0.0, 1.6]
            K[b, n] = [[focal, 0, orig_hw[1] / 2], [0, focal, orig_hw[0] / 2], [0, 0, 1]]
            resize = fW / orig_hw[1] * 1.09
            R, t = np.eye(2) * resize, -np.array([8.0, orig_hw[0] * resize - fH])
            if n % 2:
                A = np.array([[-1.0, 0.0], [0.0, 1.0]])
                R, t = A @ R, A @ t + np.array([fW, 0.0])
            th = np.deg2rad(rng.uniform(-5.4, 5.4))
            A = np.array([[np.cos(th), np.sin(th)], [-np.sin(th), np.cos(th)]])
            ctr = np.array([fW / 2.0, fH / 2.0])
            R, t = A @ R, A @ t + ctr - A @ ctr
            aug_r[b, n] = np.eye(3)
            aug_r[b, n, :2, :2], aug_t[b, n, :2] = R, t
    return rots, trans, K, aug_r, aug_t


def test_geometry_matches_jax_and_cells_differ_only_at_edges():
    """The full-width frustum (D 118 over 32 x 88 feature pixels of 256 x
    704 images, 6 cameras): xyz within 1e-5 of scale; the cells floor() gives
    equal except for points within 1e-4 of a cell edge."""
    cams = ring_cameras(1, 6, (256, 704), (32, 88))
    frustum = jvt.create_frustum((256, 704), (32, 88), tvt.DBOUND)
    assert np.array_equal(frustum, tvt.create_frustum((256, 704), (32, 88), tvt.DBOUND))
    want = np.asarray(jax.jit(jvt.get_geometry)(jnp.asarray(frustum),
                                                *map(jnp.asarray, cams)))
    got = tvt.get_geometry(torch.from_numpy(frustum), *map(torch.from_numpy, cams)).numpy()
    assert got.shape == want.shape == (1, 6, 118, 32, 88, 3)
    assert _rel(got, want) <= 1e-5
    dx, bx, _ = tvt.gen_dx_bx(tvt.XBOUND, tvt.YBOUND, tvt.ZBOUND)
    cj = (want - (bx - dx / 2.0)) / dx
    ct = (got - (bx - dx / 2.0)) / dx
    differ = np.any(np.floor(cj) != np.floor(ct), -1)
    near_edge = np.any(np.abs(cj - np.round(cj)) <= 1e-4, -1)
    n_pts = differ.size
    print(f"geometry: {int(differ.sum())} of {n_pts} points in another cell, all within 1e-4 "
          "of a cell edge")
    assert not np.any(differ & ~near_edge)
    assert differ.sum() < 1e-3 * n_pts


def _vt_inputs(seed, B=2, N=2, hw=(32, 48), cin=32):
    rng = np.random.RandomState(seed)
    fH, fW = hw[0] // 8, hw[1] // 8
    feats = rng.randn(B, N, fH, fW, cin).astype(np.float32)
    depth = (rng.rand(B, N, *hw, 1) * 30 * (rng.rand(B, N, *hw, 1) < 0.1)).astype(np.float32)
    cams = ring_cameras(B, N, hw, (fH, fW), orig_hw=(64, 96), focal=50.0, seed=seed)
    return feats, depth, cams


VT_KW = dict(xbound=(-12.0, 12.0, 0.4), ybound=(-12.0, 12.0, 0.4), zbound=(-10.0, 10.0, 20.0),
             dbound=(1.0, 25.0, 1.0))


@pytest.mark.parametrize("kind", ["depth_lss", "lss"])
def test_view_transforms_match_jax_on_the_same_cells(kind, monkeypatch):
    """Both transforms at a 60 x 60 grid, 24 depth bins, 16 channels; the
    port is fed JAX's geometry (its own differs at cell edges, above)."""
    feats, depth, cams = _vt_inputs(3)
    if kind == "depth_lss":
        jm = jvt.DepthLSSTransform(in_channels=32, out_channels=16, image_size=(32, 48),
                                   feature_size=(4, 6), **VT_KW)
        tm = tvt.DepthLSSTransform(32, 16, (32, 48), **VT_KW)
        args = (feats, depth, *cams)
    else:
        jm = jvt.LSSTransform(in_channels=32, out_channels=16, image_size=(32, 48),
                              feature_size=(4, 6), **VT_KW)
        tm = tvt.LSSTransform(32, 16, (32, 48), **VT_KW)
        args = (feats, *cams)
    variables = _variables(jm, 4, *map(jnp.asarray, args))
    sd = vtransform_flax_to_state_dict(_flatten(variables["params"]),
                                       _flatten(variables["batch_stats"]), tm)
    _load(tm, sd)
    geom = np.asarray(jvt.get_geometry(jnp.asarray(jvt.create_frustum((32, 48), (4, 6),
                                                                      VT_KW["dbound"])),
                                       *map(jnp.asarray, cams)))
    fed = torch.from_numpy(np.ascontiguousarray(geom.transpose(0, 1, 3, 4, 2, 5)))
    monkeypatch.setattr(tvt, "get_geometry", lambda *a: fed)
    runs = _both_modes(jm, variables, tm, tuple(map(jnp.asarray, args)),
                       tuple(map(torch.from_numpy, args)))
    for got, want, _, tol in runs:
        assert tuple(got.shape) == want.shape == (2, 30, 30, 16)
        assert float(np.abs(np.asarray(want)).max()) > 0
        assert _rel(got.numpy(), want) <= tol
    stats = _flatten(runs[1][2]["batch_stats"])
    for k, v in vtransform_flax_to_state_dict(_flatten(variables["params"]), stats, tm).items():
        if "running" in k:
            assert _rel(tm.state_dict()[k].numpy(), v) <= TRAIN_TOL, k


def test_lss_fpn_matches_jax():
    """Levels of Swin's odd merges (9 x 13, 5 x 7, 3 x 4): the 2x upsample
    of 3 x 4 is cropped to 5 x 7."""
    rng = np.random.RandomState(5)
    xs = [rng.randn(2, h, w, c).astype(np.float32)
          for (h, w), c in zip(((9, 13), (5, 7), (3, 4)), (8, 16, 24))]
    jm = JaxFPN(out_channels=32, num_outs=1)
    variables = _variables(jm, 6, [jnp.asarray(x) for x in xs])
    tm = GeneralizedLSSFPN((8, 16, 24), 32, 1)
    _load(tm, lss_fpn_flax_to_state_dict(_flatten(variables["params"]),
                                         _flatten(variables["batch_stats"]), tm))
    for got, want, _, tol in _both_modes(jm, variables, tm, ([jnp.asarray(x) for x in xs],),
                                         ([torch.from_numpy(x) for x in xs],)):
        assert len(got) == len(want) == 1
        assert tuple(got[0].shape) == want[0].shape == (2, 9, 13, 32)
        assert _rel(got[0].numpy(), want[0]) <= tol


def test_fusers_match_jax():
    rng = np.random.RandomState(7)
    xs = [rng.randn(2, 10, 12, c).astype(np.float32) for c in (8, 16)]
    jx, tx = [jnp.asarray(x) for x in xs], [torch.from_numpy(x) for x in xs]
    jm = JaxConvFuser(out_channels=24)
    variables = _variables(jm, 8, jx)
    p, s = _flatten(variables["params"]), _flatten(variables["batch_stats"])
    sd = {}
    _conv_bn(p, s, "Conv_0", "BatchNorm2d_0", "fuse", sd)
    tm = _load(ConvFuser((8, 16), 24), sd)
    for got, want, _, tol in _both_modes(jm, variables, tm, (jx,), (tx,)):
        assert tuple(got.shape) == want.shape == (2, 10, 12, 24)
        assert _rel(got.numpy(), want) <= tol

    jm = JaxAddFuser(out_channels=24)
    variables = _variables(jm, 9, jx)
    p, s = _flatten(variables["params"]), _flatten(variables["batch_stats"])
    sd = {}
    for i in (0, 1):
        _conv_bn(p, s, f"Conv_{i}", f"BatchNorm2d_{i}", f"convs.{i}", sd)
    tm = _load(AddFuser((8, 16), 24), sd)
    for got, want, _, tol in _both_modes(jm, variables, tm, (jx,), (tx,)):
        assert _rel(got.numpy(), want) <= tol
    # modality dropout: at rate 1 one branch drawn from the generator is
    # zeroed and the mean is over the other alone
    tm.dropout = 1.0
    tm.eval()
    with torch.no_grad():
        alone = [tm.convs[i](tx[i].permute(0, 3, 1, 2)).permute(0, 2, 3, 1) for i in (0, 1)]
    tm.train()
    seen = set()
    for seed in range(8):
        tm.generator = torch.Generator().manual_seed(seed)
        tm.convs.eval()  # running statistics, so that a branch alone is comparable
        with torch.no_grad():
            got = tm(tx)
        hit = [i for i in (0, 1) if torch.allclose(got, alone[i], rtol=1e-6, atol=1e-6)]
        assert len(hit) == 1
        seen.add(hit[0])
    assert seen == {0, 1}
