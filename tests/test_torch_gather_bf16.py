"""The gather engine in bfloat16 (K4 and K4-dW in bf16), against the JAX
package on the CPU.

Op level: ``gather_gemm`` on bf16 features and weights (the plain version,
the CPU route) against ``dal3d_tpu/ops/sparse.py::gather_gemm`` in bf16,
and its input and weight gradients, dtype and values, against
``jax.grad``; the stem's Cin 5, the encoder's widths and a rulebook where
almost every (row, tap) misses. Both sum in f32 and round to bf16, in
another order, so the outputs are held within one bf16 ulp of their scale
(2^-7 x max|JAX|), and so is the weight gradient (one f32 sum a weight).
The input gradient rounds where each program rounds: JAX's adds a row's 27
tap terms into a bf16 sum (its scatter-add), rounding after each, as the
port's plain version does in another order; so it is held within DX_TOL.
The autograd Function of the card's route is run here with
its launches emulated by the plain version over the plan: the bf16 pads (Cin
to 16), the launches counted on the bf16 counters, the gradients' types.

Model level: the CBGS detector at ``torch_port_utils.small_cfg`` sizes on
the gather and hybrid engines at ``dtype="bfloat16"``, against JAX's same
``impl`` and dtype with the same variables (``load_flax_variables``): every
map within BF16_TOL of its scale (bf16 keeps 8 bits; two programs that
round in other orders drift apart through the 30-odd layers), and the
detections matched (same label, centre within MATCH_M, score within 0.02)
but for a tenth at most: random weights give crowds of overlapping boxes
of near-equal scores, where the NMS keeps one box in one run and its
neighbour in the other (the hybrid engine's cuDNN and XLA convs round
apart more than the gather convs do). One jitted JAX forward per
engine."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dal3d_tpu.models.backbones.scn import FPNSpMiddleResNetFHD as JaxBackbone
from dal3d_tpu.models.builder import build_detector as jax_build
from dal3d_tpu.ops import sparse as jsp
from dal3d_tpu.runtime.steps import make_predict_step as jax_make_predict_step
from dal3d_tpu.utils.config import Config as JaxConfig
from dal3d_tpu_torch.models.builder import build_detector
from dal3d_tpu_torch.models.convert_flax import load_flax_variables
from dal3d_tpu_torch.ops import gather as tg
from dal3d_tpu_torch.runtime.steps import make_predict_step
from test_torch_camera_branch import few_threads  # noqa: F401
from test_torch_predict import _randomize
from torch_port_utils import small_cfg, small_voxels, t

pytestmark = pytest.mark.usefixtures("few_threads")

ULP = 2.0 ** -7  # one bf16 ulp at a tensor's scale
# the input gradient: JAX's and the plain version's add a row's 27 tap terms
# into a bf16 sum, rounding after each, in different orders (and the card's
# Function sums them in f32 and rounds once): a few ulps apart
DX_TOL = 4 * ULP
BF16_TOL = 5e-2  # of scale: a bf16 model's maps against another program's bf16 maps
VOXEL_CAPS = (1920, 1536, 384, 128)
# a detection's centre, port against JAX: the box deltas are bf16 maps a few
# ulps apart, times anchor sizes of metres (0.1-0.25 m apart here)
MATCH_M = 0.3

# (Cin, Cout, K, M, hit fraction): the stem, L0, a 64-wide conv, and a
# rulebook where 2 % of the (row, tap) pairs hit
OP_CASES = [(5, 16, 27, 700, 0.3), (16, 32, 27, 900, 0.19), (64, 64, 27, 400, 0.4),
            (32, 64, 27, 1200, 0.02)]


def _bf16(x):
    """numpy f32 values rounded to bf16, back as f32 numpy (exact)."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16().float().numpy()


def _op_inputs(Cin, Cout, K, M, hit_p):
    rng = np.random.RandomState(Cin * 1000 + Cout + M)
    B, N = 2, 800
    f = _bf16(rng.randn(B, N, Cin))
    w = _bf16(rng.randn(K, Cin, Cout) * 0.2)
    idx = rng.randint(0, N, (B, K, M)).astype(np.int32)
    hit = rng.rand(B, K, M) < hit_p
    hit[:, :, 100:228] = False  # a whole 128-row tile without a hit
    g = rng.randn(B, M, Cout).astype(np.float32)
    return f, w, idx, hit, g


def _close(got, want, tol, what):
    got = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    want = (want.detach().float().numpy() if isinstance(want, torch.Tensor)
            else np.asarray(want, np.float32))
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err / scale)


def _jax_op(f, w, idx, hit, g):
    fj, wj = jnp.asarray(f, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    ij, hj, gj = jnp.asarray(idx), jnp.asarray(hit), jnp.asarray(g)

    def loss(fx, wx):
        return (jsp.gather_gemm(fx, ij, hj, wx).astype(jnp.float32) * gj).sum()

    out = jsp.gather_gemm(fj, ij, hj, wj)
    dx, dw = jax.grad(loss, argnums=(0, 1))(fj, wj)
    assert out.dtype == dx.dtype == dw.dtype == jnp.bfloat16
    return [np.asarray(a.astype(jnp.float32)) for a in (out, dx, dw)]


@pytest.mark.parametrize("Cin,Cout,K,M,hit_p", OP_CASES)
def test_op_and_gradients_match_jax(Cin, Cout, K, M, hit_p):
    f, w, idx, hit, g = _op_inputs(Cin, Cout, K, M, hit_p)
    ref_out, ref_dx, ref_dw = _jax_op(f, w, idx, hit, g)
    x = t(f).bfloat16().requires_grad_(True)
    wt = t(w).bfloat16().requires_grad_(True)
    out = tg.gather_gemm(x, t(idx), t(hit), wt)
    assert out.dtype == torch.bfloat16
    (out.float() * t(g)).sum().backward()
    assert x.grad.dtype == wt.grad.dtype == torch.bfloat16
    _close(out, ref_out, ULP, "out")
    _close(x.grad, ref_dx, DX_TOL, "dx")
    _close(wt.grad, ref_dw, ULP, "dw")
    assert float(np.abs(ref_out[:, 100:228]).max()) == 0.0
    assert float(out.detach()[:, 100:228].abs().max()) == 0.0
    # the weight-gradient kernels' plain version: bf16 dW, f32 sums, one rounding
    dw = tg.gather_dw(t(f).bfloat16(), t(idx), t(hit), t(g).bfloat16())
    assert dw.dtype == torch.bfloat16
    _close(dw, ref_dw, ULP, "gather_dw")


def _over_plan(features, plan, weights):
    """What the K4 kernels compute over a plan, in plain PyTorch."""
    rb = plan.rulebook
    out = tg.gather_gemm_plain(features, torch.clamp(rb, min=0), rb >= 0, weights)
    if plan.order is not None:
        out = torch.empty_like(out).scatter_(1, plan.order[..., None].expand_as(out), out)
    (tg.gather_gemm_bf16 if features.dtype == torch.bfloat16 else tg.gather_gemm).launches += 1
    return out


def _dw_over_plan(features, plan, g):
    rb = plan.rulebook
    if plan.order is not None:
        g = torch.gather(g, 1, plan.order[..., None].expand_as(g))
    (tg.gather_dw_bf16 if features.dtype == torch.bfloat16 else tg.gather_dw).launches += 1
    return tg.gather_dw_plain(features, torch.clamp(rb, min=0), rb >= 0, g)


@pytest.mark.parametrize("symmetric", [True, False])
def test_function_route_in_bf16(symmetric, monkeypatch):
    """The card's autograd Function with its launches emulated: Cin 5 padded
    to 16, the dX launch's Cout cut back, one forward, one dX and one dW
    launch on the bf16 counters, bf16 gradients that match autograd through
    the plain version within one ulp (the Function's dX sums the taps in f32
    and rounds once, where the plain version's rounds each tap's rows)."""
    monkeypatch.setattr(tg, "_launch_gemm", _over_plan)
    monkeypatch.setattr(tg, "_launch_dw", _dw_over_plan)
    Cin, Cout = 5, 16
    f, w, idx, hit, g = _op_inputs(Cin, Cout, 27, 800, 0.3)
    hit_t = t(hit)
    if symmetric:  # a submanifold rulebook: tap K-1-k the inverse of tap k
        hit_t = hit_t | hit_t.flip(1)
        idx_t = torch.where(hit_t, torch.arange(800, dtype=torch.int32).expand(2, 27, 800), 0)
    else:  # a strided conv's: one tap reads an input row for one output row at most
        rng = np.random.RandomState(5)
        idx_t = t(np.stack([[rng.permutation(800) for _ in range(27)] for _ in range(2)])
                  .astype(np.int32))
    plan = tg.gather_plan(idx_t, hit_t, symmetric=symmetric)
    xr = t(f).bfloat16().requires_grad_(True)
    wr = t(w).bfloat16().requires_grad_(True)
    n4, nb, nw, nwb = (tg.gather_gemm.launches, tg.gather_gemm_bf16.launches,
                       tg.gather_dw.launches, tg.gather_dw_bf16.launches)
    Cinp, Coutp = tg._chan_pad(Cin, torch.bfloat16), tg._cout_pad(Cout)
    assert Cinp == 16
    out = tg._GatherGemm.apply(F.pad(xr, (0, Cinp - Cin)),
                               F.pad(wr, (0, Coutp - Cout, 0, Cinp - Cin)), plan)[..., :Cout]
    assert out.dtype == torch.bfloat16
    (out.float() * t(g)).sum().backward()
    assert (tg.gather_gemm.launches - n4, tg.gather_gemm_bf16.launches - nb,
            tg.gather_dw.launches - nw, tg.gather_dw_bf16.launches - nwb) == (0, 2, 0, 1)
    assert xr.grad.dtype == wr.grad.dtype == torch.bfloat16
    x0 = t(f).bfloat16().requires_grad_(True)
    w0 = t(w).bfloat16().requires_grad_(True)
    ref = tg.gather_gemm_plain(x0, idx_t, hit_t, w0)
    (ref.float() * t(g)).sum().backward()
    _close(out, ref, ULP, "out")
    _close(xr.grad, x0.grad, DX_TOL, "dx")
    _close(wr.grad, w0.grad, ULP, "dw")


def test_card_route_refuses_other_types():
    """The dtype rule of the card's route, checked before anything else off
    the CPU: f16, f64 and mixed operands raise TypeError (meta tensors
    stand for the card's); f32 and bf16 pass it and stop at the device."""
    idx = torch.zeros(1, 2, 4, dtype=torch.int32, device="meta")
    hit = torch.ones(1, 2, 4, dtype=torch.bool, device="meta")
    for fd, wd in ((torch.float16, torch.float16), (torch.float64, torch.float64),
                   (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
                   (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16)):
        feats = torch.zeros(1, 8, 16, dtype=fd, device="meta")
        w = torch.zeros(2, 16, 16, dtype=wd, device="meta")
        g = torch.zeros(1, 4, 16, dtype=wd, device="meta")
        err = ValueError if fd == wd and fd in (torch.float32, torch.bfloat16) else TypeError
        with pytest.raises(err):
            tg.gather_gemm(feats, idx, hit, w)
        with pytest.raises(err):
            tg.gather_dw(feats, idx, hit, g)


# --- the detector -----------------------------------------------------------


def engine_cfg(impl):
    cfg = copy.deepcopy(small_cfg("bfloat16"))
    bb = cfg["model"]["backbone"]
    for k in ("banded_caps", "band_widths", "down_bands", "band_fb_cap", "brick_caps"):
        bb.pop(k, None)
    bb.update(impl=impl, dtype="bfloat16", voxel_caps=VOXEL_CAPS)
    return cfg


@pytest.fixture(scope="module", params=["gather", "hybrid"])
def jax_ref(request):
    impl = request.param
    vf, vc, vv = small_voxels(0)
    jb = jax_build(JaxConfig(engine_cfg(impl)))
    assert jb.model.backbone_impl == impl
    voxels = (jnp.asarray(vf), jnp.asarray(vc), jnp.asarray(vv))
    dummy = (jnp.zeros((2, 1, 5), jnp.float32), jnp.zeros((2, 1), bool))
    shapes = jax.eval_shape(lambda: jb.model.init(jax.random.PRNGKey(0), *dummy, False,
                                                  voxels=voxels))
    variables = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape), shapes),
                           np.random.RandomState(1))
    predict = jax_make_predict_step(jb)

    @jax.jit
    def run(variables, voxels):
        jout, state = jb.model.apply(
            variables, *dummy, False, voxels=voxels, mutable=["intermediates"],
            capture_intermediates=lambda mdl, _: isinstance(mdl, JaxBackbone))
        dets = predict(variables["params"], variables["batch_stats"],
                       {"voxel_features": voxels[0], "voxel_coords": voxels[1],
                        "voxel_valid": voxels[2]})
        maps = {"dense": state["intermediates"]["FPNSpMiddleResNetFHD_0"]["__call__"][0][0],
                "neck": jout["neck_feat"], "embedding": jout["embedding"]}
        for i, p in enumerate(jout["preds"]):
            maps[f"box_preds{i}"], maps[f"cls_preds{i}"] = p["box_preds"], p["cls_preds"]
        return maps, dets

    maps, dets = run(variables, voxels)
    maps = {k: np.asarray(v.astype(jnp.float32)) for k, v in maps.items()}
    return impl, variables, maps, jax.tree_util.tree_map(np.asarray, dets)


def _matched(td, jd, b):
    """(port detections of frame b matched by one of JAX's, port's, JAX's)."""
    tv, jv = td["det_valid"][b].numpy(), jd["det_valid"][b]
    tb_, jb_ = td["box3d_lidar"][b].numpy()[tv], jd["box3d_lidar"][b][jv]
    ts, js = td["scores"][b].float().numpy()[tv], np.asarray(jd["scores"][b], np.float32)[jv]
    tl, jl = td["label_preds"][b].numpy()[tv], jd["label_preds"][b][jv]
    d = np.linalg.norm(tb_[:, None, :2] - jb_[None, :, :2], axis=-1)
    ok = ((d < MATCH_M) & (tl[:, None] == jl[None, :])
          & (np.abs(ts[:, None] - js[None, :]) < 0.02))
    return int(ok.any(1).sum()), len(ts), len(js)


def test_bf16_detector_matches_jax(jax_ref):
    impl, variables, ref_maps, jd = jax_ref
    tb = build_detector(engine_cfg(impl), device="cpu")
    assert tb.model.backbone.impl == impl
    assert tb.model.backbone.l0.stem.dtype == torch.bfloat16
    load_flax_variables(tb.model, variables)
    vf, vc, vv = small_voxels(0)
    with torch.inference_mode():
        out = tb.model(t(vf), t(vc), t(vv))
    maps = {"dense": out["dense"], "neck": out["neck_feat"], "embedding": out["embedding"]}
    for i, p in enumerate(out["preds"]):
        maps[f"box_preds{i}"], maps[f"cls_preds{i}"] = p["box_preds"], p["cls_preds"]
    assert np.abs(ref_maps["dense"]).max() > 0
    for name, ref in ref_maps.items():
        _close(maps[name], ref, BF16_TOL, name)
    td = make_predict_step(tb)({"voxel_features": vf, "voxel_coords": vc, "voxel_valid": vv})
    for b in range(2):
        found, n_t, n_j = _matched(td, jd, b)
        assert n_t > 10 and abs(n_t - n_j) <= max(2, n_j // 20), (b, n_t, n_j)
        assert found >= n_t - max(3, n_t // 10), (b, found, n_t)
