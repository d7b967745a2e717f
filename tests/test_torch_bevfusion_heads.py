"""Port parity of BEVFusion's CenterPoint head and map-segmentation head
(``models/bevfusion/centerpoint.py``, ``segm.py``) against the JAX package's,
on the CPU.

One jitted JAX function runs both flax heads in eval and in train mode on a
[2, 16, 16, 24] map, and from its eval outputs the decode, the centre loss
and the seg loss with their gradients w.r.t. the logits, and the mIoU. The
port's heads get the same numpy-randomised weights through the weights
bridge (``center_head_flax_to_state_dict``, ``seg_head_flax_to_state_dict``).
Required: the heads within 1e-5 of scale in eval mode and 1e-4 in train mode
(flax's fast variance E[x^2] - E[x]^2); the decode, fed JAX's own logits,
with equal classes and validity and boxes and scores within 1e-6; the losses
and their gradients within 1e-5 of scale; the mIoU equal; gaussian_radius
bit-equal."""
import jax
import numpy as np
import pytest
import torch
from flax import linen as fnn

from dal3d_tpu.models.bevfusion import centerpoint as jcp
from dal3d_tpu.models.bevfusion import segm as jsegm
from dal3d_tpu_torch.models.bevfusion import centerpoint as tcp
from dal3d_tpu_torch.models.bevfusion import segm as tsegm
from dal3d_tpu_torch.models.convert_flax import (_flatten, center_head_flax_to_state_dict,
                                                 seg_head_flax_to_state_dict)
from test_torch_camera_branch import few_threads  # noqa: F401
from torch_port_utils import t

pytestmark = pytest.mark.usefixtures("few_threads")

B, H, W, C = 2, 16, 16, 24
NC = (1, 2)
JCFG = jcp.CenterTestCfg(out_size_factor=8, voxel_size=(0.1, 0.1), pc_range=(-6.4, -6.4),
                         max_per_task=20, score_threshold=0.75)
TCFG = tcp.CenterTestCfg(out_size_factor=8, voxel_size=(0.1, 0.1), pc_range=(-6.4, -6.4),
                         max_per_task=20, score_threshold=0.75)


class _Heads(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool):
        return jcp.CenterHead(num_classes=NC)(x, train), jsegm.BEVSegmentationHead()(x, train)


def _randomize(tree, rng, path=""):
    out = {}
    for k, v in tree.items():
        p = f"{path}/{k}"
        if isinstance(v, dict):
            out[k] = _randomize(v, rng, p)
            continue
        shape = np.shape(v)
        if k == "kernel":
            x = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
        elif k == "scale":
            x = 1 + 0.2 * rng.randn(*shape)
        elif k == "var":
            x = 1 + 0.1 * rng.rand(*shape)
        elif k == "mean" or ("Norm" in p and k == "bias"):
            x = 0.1 * rng.randn(*shape)
        else:
            x = 0.3 * rng.randn(*shape)
        out[k] = x.astype(np.float32)
    return out


def _gt(rng):
    """Per task: [B, 6, 9] boxes over +-8 m (some outside the 12.8 m grid),
    task-local classes with padding."""
    boxes, classes = [], []
    for nc in NC:
        b = np.zeros((B, 6, 9), np.float32)
        b[..., :2] = rng.uniform(-8, 8, (B, 6, 2))
        b[..., 2] = rng.uniform(-2, 0, (B, 6))
        b[..., 3:6] = rng.uniform(0.5, 4, (B, 6, 3))
        b[..., 6:8] = rng.uniform(-1, 1, (B, 6, 2))
        b[..., 8] = rng.uniform(-3.1, 3.1, (B, 6))
        c = rng.randint(1, nc + 1, (B, 6)).astype(np.int32)
        c[:, 4:] = 0
        boxes.append(b)
        classes.append(c)
    return boxes, classes


@pytest.fixture(scope="module")
def ref():
    rng = np.random.RandomState(0)
    x = rng.randn(B, H, W, C).astype(np.float32)
    model = _Heads()
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, False))
    variables = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape), shapes), rng)
    gtb, gtc = _gt(rng)
    seg_t = (rng.rand(B, H, W, 6) < 0.4).astype(np.float32)

    @jax.jit
    def run(variables, x, gtb, gtc, seg_t):
        cp, seg = model.apply(variables, x, False)
        train, stats = model.apply(variables, x, True, mutable=["batch_stats"])
        closs, cgrad = jax.value_and_grad(
            lambda c: jcp.center_head_loss(c, gtb, gtc, JCFG)["loss"])(cp)
        sloss, sgrad = jax.value_and_grad(
            lambda s: jsegm.bev_segmentation_loss(s, seg_t)["loss"])(seg)
        return dict(eval=(cp, seg), train=train, stats=stats["batch_stats"],
                    decode=jcp.center_head_decode(cp, JCFG), closs=closs, cgrad=cgrad,
                    sloss=sloss, sgrad=sgrad, miou=jsegm.bev_segmentation_miou(seg, seg_t))

    out = jax.tree_util.tree_map(np.asarray, run(variables, x, gtb, gtc, seg_t))
    return variables, x, gtb, gtc, seg_t, out


def _port_heads(variables):
    ch, sh = tcp.CenterHead(C, NC), tsegm.BEVSegmentationHead(C)
    p, s = _flatten(variables["params"]), _flatten(variables["batch_stats"])
    for head, fn, src in ((ch, center_head_flax_to_state_dict, "CenterHead_0/"),
                          (sh, seg_head_flax_to_state_dict, "BEVSegmentationHead_0/")):
        sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in fn(p, s, head, src).items()}
        head.load_state_dict(sd, strict=True)
    return ch, sh


def _close(got, want, tol, name):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_heads_match_flax(ref, mode):
    variables, x, _, _, _, out = ref
    ch, sh = _port_heads(variables)
    for m in (ch, sh):
        m.train(mode == "train")
    cp, seg = ch(t(x)), sh(t(x))
    jcp_out, jseg = out["eval"] if mode == "eval" else out["train"]
    tol = 1e-5 if mode == "eval" else 1e-4
    assert len(cp) == len(NC)
    for i, (p, q) in enumerate(zip(cp, jcp_out)):
        assert set(p) == set(q)
        for k in p:
            _close(p[k], q[k], tol, f"task {i} {k}")
    _close(seg, jseg, tol, "seg_logits")
    if mode == "train":  # the moved running statistics of the shared conv's BN
        st = out["stats"]["CenterHead_0"]["BatchNorm2d_0"]["BatchNorm_0"]
        _close(ch.shared.bn.running_mean, st["mean"], tol, "running_mean")
        _close(ch.shared.bn.running_var, st["var"], tol, "running_var")


def test_decode_on_jax_logits(ref):
    out = ref[-1]
    preds = [{k: t(v) for k, v in p.items()} for p in out["eval"][0]]
    got = tcp.center_head_decode(preds, TCFG)
    want = out["decode"]
    assert 0 < int(want["det_valid"].sum()) < want["det_valid"].size
    np.testing.assert_array_equal(got["label_preds"].numpy(), want["label_preds"])
    assert got["label_preds"].dtype == torch.int32
    np.testing.assert_array_equal(got["det_valid"].numpy(), want["det_valid"])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["box3d_lidar"].numpy(), want["box3d_lidar"], rtol=1e-6,
                               atol=1e-6)


def test_losses_gradients_and_miou(ref):
    _, _, gtb, gtc, seg_t, out = ref
    preds = [{k: t(v).requires_grad_() for k, v in p.items()} for p in out["eval"][0]]
    loss = tcp.center_head_loss(preds, [t(b) for b in gtb], [t(c) for c in gtc], TCFG)["loss"]
    loss.backward()
    _close(loss, out["closs"], 1e-5, "center loss")
    for i, (p, g) in enumerate(zip(preds, out["cgrad"])):
        for k in p:
            _close(p[k].grad, g[k], 1e-5, f"center grad {i} {k}")
    logits = t(out["eval"][1]).requires_grad_()
    sloss = tsegm.bev_segmentation_loss(logits, t(seg_t))["loss"]
    sloss.backward()
    _close(sloss, out["sloss"], 1e-5, "seg loss")
    _close(logits.grad, out["sgrad"], 1e-5, "seg grad")
    miou = tsegm.bev_segmentation_miou(t(out["eval"][1]), t(seg_t))
    np.testing.assert_array_equal(miou.numpy(), out["miou"])
    # an absent class has IoU 0, as in JAX
    empty = np.full((1, 2, 2, 6), -5.0, np.float32)
    np.testing.assert_array_equal(
        tsegm.bev_segmentation_miou(t(empty), t(np.zeros_like(empty))).numpy(), np.zeros(6))


def test_gaussian_radius_bit_equal():
    rng = np.random.RandomState(3)
    h, w = rng.uniform(0.1, 30, 500), rng.uniform(0.1, 30, 500)
    for ov in (0.1, 0.5, 0.7):
        np.testing.assert_array_equal(tcp.gaussian_radius(h, w, ov), jcp.gaussian_radius(h, w, ov))
    assert tcp.gaussian_radius(2.0, 3.0) == jcp.gaussian_radius(2.0, 3.0)
