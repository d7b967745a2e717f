"""Port parity: the training losses (dal3d_tpu_torch/models/losses/losses.py,
models/heads/mg_head.py::multi_group_loss) against the JAX package on the same
numpy inputs, values and gradients, f32, rtol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.models.heads.mg_head import LossConfig as JaxLossConfig
from dal3d_tpu.models.heads.mg_head import multi_group_loss as jax_multi_group_loss
from dal3d_tpu.models.losses import losses as jl
from dal3d_tpu_torch.models.builder import build_detector
from dal3d_tpu_torch.models.heads.mg_head import LossConfig, multi_group_loss
from dal3d_tpu_torch.models.losses import losses as tl
from torch_port_utils import small_cfg, t

NORMS = ("norm_by_num_positives", "norm_by_num_examples", "norm_by_num_pos_neg", "dont_norm")
# the cases of tests/test_loss_norm.py: 2 positives, 3 negatives, 1 ignore
LAB = np.array([[1, 2, 0, 0, 0, -1]])
RAW_CLS = np.array([[1.0, 1.0, 2.0, 2.0, 2.0, 0.0]])
RAW_REG = np.array([[1.0, 1.0, 0.0, 0.0, 0.0, 0.0]])
WANT = {
    "norm_by_num_positives": (RAW_CLS / 2.0, RAW_REG / 2.0),
    "norm_by_num_examples": (RAW_CLS / 5.0, RAW_REG / 2.0),
    "norm_by_num_pos_neg": (np.array([[0.5, 0.5, 2 / 3, 2 / 3, 2 / 3, 0.0]]), RAW_REG / 2.0),
    "dont_norm": (RAW_CLS, RAW_REG / 2.0),
}


@pytest.mark.parametrize("norm", NORMS)
def test_loss_weights_match_oracle_and_jax(norm):
    c, r, cared = tl.prepare_loss_weights(t(LAB), 1.0, 2.0, norm)
    np.testing.assert_array_equal(cared.numpy(), [[1, 1, 1, 1, 1, 0]])
    np.testing.assert_allclose(c.numpy(), WANT[norm][0], rtol=1e-6)
    np.testing.assert_allclose(r.numpy(), WANT[norm][1], rtol=1e-6)
    rng = np.random.RandomState(0)
    lab = rng.randint(-1, 3, (3, 50))
    lab[2] = np.where(lab[2] > 0, 0, lab[2])  # a sample with no positives: clamps
    ref = jl.prepare_loss_weights(jnp.asarray(lab), 1.0, 2.0, norm)
    got = tl.prepare_loss_weights(t(lab), 1.0, 2.0, norm)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        assert bool(torch.isfinite(a.float()).all())


def test_unknown_norm_type_raises():
    with pytest.raises(ValueError):
        tl.prepare_loss_weights(t(LAB), 1.0, 2.0, "bogus")


def _grad_pair(jax_fn, torch_fn, x):
    ref_v, ref_g = jax.value_and_grad(lambda a: jnp.sum(jax_fn(a)))(jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    out = torch_fn(xt)
    out.sum().backward()
    return (out.detach().numpy(), xt.grad.numpy()), (np.asarray(jax_fn(jnp.asarray(x))), np.asarray(ref_g))


def test_focal_loss_matches_jax():
    rng = np.random.RandomState(1)
    logits = (rng.randn(2, 40, 3) * 4).astype(np.float32)
    targets = np.eye(4, dtype=np.float32)[rng.randint(0, 4, (2, 40))][..., 1:]
    weights = rng.rand(2, 40).astype(np.float32)
    got, ref = _grad_pair(
        lambda a: jl.sigmoid_focal_loss(a, jnp.asarray(targets), jnp.asarray(weights), 2.0, 0.25),
        lambda a: tl.sigmoid_focal_loss(a, t(targets), t(weights), 2.0, 0.25), logits)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("use_code_weights", [False, True])
def test_smooth_l1_matches_jax(use_code_weights):
    rng = np.random.RandomState(2)
    preds = rng.randn(2, 30, 10).astype(np.float32)
    targets = (preds + rng.randn(2, 30, 10) * 0.2).astype(np.float32)  # both branches
    weights = rng.rand(2, 30).astype(np.float32)
    cw = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.2, 0.2, 1.0, 1.0)
    got, ref = _grad_pair(
        lambda a: jl.weighted_smooth_l1(a, jnp.asarray(targets), jnp.asarray(weights), 3.0, cw,
                                        use_code_weights),
        lambda a: tl.weighted_smooth_l1(a, t(targets), t(weights), 3.0, cw, use_code_weights),
        preds)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("norm", NORMS)
def test_multi_group_loss_matches_jax(norm):
    rng = np.random.RandomState(3)
    num_classes = (1, 2)
    B, L = 2, 16
    preds, labels, targets = [], [], []
    for nc in num_classes:
        A = L * nc * 2
        preds.append({"box_preds": rng.randn(B, 4, 4, nc * 2 * 10).astype(np.float32),
                      "cls_preds": rng.randn(B, 4, 4, nc * 2 * nc).astype(np.float32)})
        labels.append(rng.randint(-1, nc + 1, (B, A)).astype(np.int32))
        targets.append((rng.randn(B, A, 10) * (labels[-1] > 0)[..., None]).astype(np.float32))
    kw = dict(loss_norm_type=norm, neg_cls_weight=2.0)
    ref = jax_multi_group_loss(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in preds],
        [jnp.asarray(x) for x in labels], [jnp.asarray(x) for x in targets], num_classes,
        JaxLossConfig(**kw))
    got = multi_group_loss([{k: t(v) for k, v in p.items()} for p in preds],
                           [t(x) for x in labels], [t(x) for x in targets], num_classes,
                           LossConfig(**kw))
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), rtol=1e-5)
    for k in ("loc_loss", "cls_loss", "num_pos"):
        np.testing.assert_allclose([float(x) for x in got[k]], [float(x) for x in ref[k]],
                                   rtol=1e-5)


def test_builder_reads_the_loss_config():
    b = build_detector(small_cfg(), device="cpu")
    assert b.loss_cfg == LossConfig(
        pos_cls_weight=1.0, neg_cls_weight=2.0, loss_norm_type="norm_by_num_positives",
        focal_gamma=2.0, focal_alpha=0.25, cls_loss_weight=1.0, loc_loss_weight=0.25,
        smooth_l1_sigma=3.0,
        code_weights=(1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.2, 0.2, 1.0, 1.0))
    assert b.num_classes == (1, 2, 2, 1, 2, 2) and len(b.assigner.task_anchors) == 6


# --- the partial-label losses and heads (models/heads/mg_loss_head.py) -----

def _loss_inputs(rng, C=3):
    logits = (rng.randn(2, 60, C) * 3).astype(np.float32)
    one_hot = np.eye(C + 1, dtype=np.float32)[rng.randint(0, C + 1, (2, 60))][..., 1:]
    weights = (rng.rand(2, 60) * (rng.rand(2, 60) > 0.3)).astype(np.float32)
    return logits, one_hot, weights


def _softmax_ce(lib, x, y, w):
    return lib.weighted_softmax_cross_entropy(x, y, w, logit_scale=2.0)


def _balanced_l1(lib, x, y, w):  # diffs on both sides of beta
    return lib.balanced_l1_loss(x, x * 0.5 + y * 2.0, w)


def _ghm(lib, x, y, w):
    return lib.ghm_classification_loss(x, y, w)


def _iou_reg(lib, x, y, w):
    return lib.iou_regression_loss(x[..., 0], y[..., 0] * 0.5 + 0.1 * x[..., 1], w)


@pytest.mark.parametrize("loss", [_softmax_ce, _balanced_l1, _ghm, _iou_reg],
                         ids=["softmax_ce", "balanced_l1", "ghm", "iou_regression"])
def test_partial_label_losses_match_jax(loss):
    """The four losses of the partial-label heads, values within 1e-6
    relative (GHM's bins, the 1e-6 widening of its last bin, and the
    zero-weight anchors that leave its count included)."""
    rng = np.random.RandomState(7)
    logits, one_hot, weights = _loss_inputs(rng)
    logits[0, :5] = [[20.0, -20.0, 0.0]] * 5  # |p - y| at 0 and 1: the edge bins
    one_hot[0, :5] = [[1.0, 0.0, 0.0]] * 5
    ref = np.asarray(loss(jl, jnp.asarray(logits), jnp.asarray(one_hot), jnp.asarray(weights)))
    got = loss(tl, t(logits), t(one_hot), t(weights)).numpy()
    assert got.shape == ref.shape and np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def heads():
    """Both packages' anchors and coders on the small config's 8x8 map (its
    first two task groups: the JAX references compile in a third of the
    time of six), and random per-task head maps with an IoU branch."""
    from dal3d_tpu.models.builder import build_detector as jax_build
    from dal3d_tpu.utils.config import Config as JaxConfig
    from torch_port_utils import small_gt

    cfg = small_cfg("float32")
    cfg["tasks"] = cfg["tasks"][:2]
    cfg["target_assigner"]["anchor_generators"] = cfg["target_assigner"]["anchor_generators"][:3]
    jb, tb = jax_build(JaxConfig(cfg)), build_detector(cfg, device="cpu")
    rng = np.random.RandomState(11)
    B, preds, labels, targets = 2, [], [], []
    for ta in tb.task_anchors:
        nc, A = ta.num_classes, ta.anchors.shape[0]
        preds.append({"box_preds": (rng.randn(B, 8, 8, nc * 2 * 10) * 0.5).astype(np.float32),
                      "cls_preds": (rng.randn(B, 8, 8, nc * 2 * nc) * 2).astype(np.float32),
                      "iou_preds": rng.randn(B, 8, 8, nc * 2).astype(np.float32)})
        labels.append(rng.randint(-1, nc + 1, (B, A)).astype(np.int32))
        targets.append((rng.randn(B, A, 10) * 0.3).astype(np.float32))
    gt_boxes, gt_classes = small_gt(cfg, 3, per_task=2)
    return dict(jb=jb, tb=tb, preds=preds, labels=labels, targets=targets,
                gt_boxes=gt_boxes, gt_classes=gt_classes)


IOU_CASES = [(f, c) for f in ("smooth_l1", "sigmoid") for c in (True, False)]


@pytest.fixture(scope="module")
def iou_loss_refs(heads):
    """JAX's ``multi_group_loss_with_iou`` for every (flavour, GT classes
    given) case, in one compiled call."""
    from dal3d_tpu.models.heads.mg_loss_head import multi_group_loss_with_iou as jax_fn

    h, jb = heads, heads["jb"]

    def all_cases(p, lab, tg, gb, gc):
        return {f"{f}-{c}": jax_fn(p, lab, tg, jb.task_anchors, jb.box_coder, gb,
                                   jb.num_classes, jb.loss_cfg, iou_loss_weight=0.7,
                                   iou_loss_type=f, gt_classes_by_task=gc if c else None)
                for f, c in IOU_CASES}

    out = jax.jit(all_cases)(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in h["preds"]],
        [jnp.asarray(x) for x in h["labels"]], [jnp.asarray(x) for x in h["targets"]],
        [jnp.asarray(x) for x in h["gt_boxes"]], [jnp.asarray(x) for x in h["gt_classes"]])
    return {k: {n: float(v[n]) for n in ("loss", "iou_loss")} for k, v in out.items()}


@pytest.mark.parametrize("flavour,with_classes", IOU_CASES)
def test_multi_group_loss_with_iou_matches_jax(heads, iou_loss_refs, flavour, with_classes):
    from dal3d_tpu_torch.models.heads.mg_loss_head import multi_group_loss_with_iou

    h, tb = heads, heads["tb"]
    ref = iou_loss_refs[f"{flavour}-{with_classes}"]
    got = multi_group_loss_with_iou(
        [{k: t(v) for k, v in p.items()} for p in h["preds"]], [t(x) for x in h["labels"]],
        [t(x) for x in h["targets"]], tb.task_anchors, tb.box_coder,
        [t(x) for x in h["gt_boxes"]], tb.num_classes, tb.loss_cfg, iou_loss_weight=0.7,
        iou_loss_type=flavour,
        gt_classes_by_task=[t(x) for x in h["gt_classes"]] if with_classes else None)
    assert ref["iou_loss"] > 0
    for k in ("loss", "iou_loss"):
        np.testing.assert_allclose(float(got[k]), ref[k], rtol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def iou_predict_refs(heads):
    """JAX's ``multi_group_predict`` with the IoU branch at both rescoring
    strengths, in one compiled call."""
    import dataclasses

    from dal3d_tpu.models.heads.mg_head import multi_group_predict as jax_predict

    jb = heads["jb"]
    jcfg = dataclasses.replace(jb.test_cfg, score_threshold=0.0)
    out = jax.jit(lambda p: {a: jax_predict(p, jb.task_anchors, jb.box_coder, jcfg,
                                            iou_rescore_alpha=a) for a in (0.0, 0.5)})(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in heads["preds"]])
    return jax.device_get(out)


@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_predict_with_iou_preds_matches_jax(heads, iou_predict_refs, alpha):
    """``multi_group_predict`` with an IoU branch: the decoded IoU threaded
    through candidate selection (and the score^(1-a) * iou^a rescoring at
    a = 0.5) gives JAX's post-NMS set, with its ``iou_preds``."""
    import dataclasses

    from dal3d_tpu_torch.models.heads.mg_head import multi_group_predict

    h, tb = heads, heads["tb"]
    tcfg = dataclasses.replace(tb.test_cfg, score_threshold=0.0)
    ref = iou_predict_refs[alpha]
    got = multi_group_predict([{k: t(v) for k, v in p.items()} for p in h["preds"]],
                              tb.task_anchors, tb.box_coder, tcfg, iou_rescore_alpha=alpha)
    for b in range(2):
        jv, tv = np.asarray(ref["det_valid"][b]), got["det_valid"][b].numpy()
        assert jv.sum() == tv.sum() > 10
        js, ts = np.asarray(ref["scores"][b])[jv], got["scores"][b].numpy()[tv]
        jo, to = np.argsort(-js, kind="stable"), np.argsort(-ts, kind="stable")
        np.testing.assert_allclose(ts[to], js[jo], rtol=1e-5, atol=1e-6)
        for k in ("iou_preds", "box3d_lidar"):
            np.testing.assert_allclose(got[k][b].numpy()[tv][to], np.asarray(ref[k][b])[jv][jo],
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(got["label_preds"][b].numpy()[tv][to],
                                      np.asarray(ref["label_preds"][b])[jv][jo])


def test_predict_breaks_score_ties_as_jax(heads):
    """Scores tied at the candidate cut, as a briefly trained model gives
    them at score threshold 0 (logits that saturate the sigmoid to exactly
    1 or 0 in f32, more tied anchors than ``nms_pre_max_size``):
    ``multi_group_predict`` keeps JAX's candidates and output order slot for
    slot (``lax.top_k``: the lower index first among equal values).
    ``torch.topk`` promises no order among ties, and the CPU and the card
    broke them differently, so the same checkpoint gave each its own
    detections."""
    import dataclasses

    from dal3d_tpu.models.heads.mg_head import multi_group_predict as jax_predict
    from dal3d_tpu_torch.models.heads.mg_head import multi_group_predict

    h, jb, tb = heads, heads["jb"], heads["tb"]
    rng = np.random.RandomState(17)
    preds = []
    for p in h["preds"]:
        cls = np.where(rng.rand(*p["cls_preds"].shape) < 0.5, 40.0, -120.0).astype(np.float32)
        preds.append({"box_preds": p["box_preds"], "cls_preds": cls})
    cut = dict(score_threshold=0.0, nms_pre_max_size=40, nms_post_max_size=12)
    jcfg = dataclasses.replace(jb.test_cfg, use_approx_topk=False, **cut)
    ref = jax.device_get(jax.jit(lambda p: jax_predict(p, jb.task_anchors, jb.box_coder, jcfg))(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in preds]))
    got = multi_group_predict([{k: t(v) for k, v in p.items()} for p in preds],
                              tb.task_anchors, tb.box_coder,
                              dataclasses.replace(tb.test_cfg, **cut))
    valid = np.asarray(ref["det_valid"])
    assert valid.sum() > 10
    np.testing.assert_array_equal(got["det_valid"].numpy(), valid)
    np.testing.assert_array_equal(got["scores"].numpy()[valid], np.asarray(ref["scores"])[valid])
    np.testing.assert_array_equal(got["label_preds"].numpy()[valid],
                                  np.asarray(ref["label_preds"])[valid])
    np.testing.assert_allclose(got["box3d_lidar"].numpy()[valid],
                               np.asarray(ref["box3d_lidar"])[valid], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["iou", "loss"])
@pytest.mark.parametrize("train", [False, True])
def test_iou_and_loss_heads_match_jax(kind, train):
    """``MultiGroupIoUHead`` / ``MultiGroupLossHead`` forward with weights
    carried by ``convert_flax.mg_head_flax_to_state_dict``: every map within
    1e-5 (train mode: batch statistics, and the updated running ones)."""
    from dal3d_tpu.models.heads import mg_loss_head as jh
    from dal3d_tpu_torch.models.convert_flax import mg_head_flax_to_state_dict
    from dal3d_tpu_torch.models.heads import mg_loss_head as th
    from test_torch_predict import _randomize

    nc, C = (1, 2), 32
    x = np.random.RandomState(5).randn(3, 4, 4, C).astype(np.float32)
    if kind == "iou":
        jm, tm = jh.MultiGroupIoUHead(nc, iou_hidden=16), th.MultiGroupIoUHead(
            nc, in_channels=C, iou_hidden=16)
    else:
        jm, tm = jh.MultiGroupLossHead(nc, num_loss=2), th.MultiGroupLossHead(
            nc, in_channels=C, num_loss=2)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape), shapes),
                           np.random.RandomState(2))
    tm.load_state_dict(mg_head_flax_to_state_dict(variables, tm), strict=True)
    tm.train(train)
    if train:
        ref, new = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        ref = jm.apply(variables, jnp.asarray(x))
    got = tm(t(x))
    extra = "iou_preds" if kind == "iou" else "loss_preds"
    for jp, tp in zip(ref, got):
        for k in ("box_preds", "cls_preds", extra):
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
    if train:
        sd = tm.state_dict()
        for i in range(len(nc)):
            st = new["batch_stats"][f"{kind}_bn_{i}"]
            np.testing.assert_allclose(sd[f"{kind}.{i}.bn.running_mean"].numpy(),
                                       np.asarray(st["mean"]), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(sd[f"{kind}.{i}.bn.running_var"].numpy(),
                                       np.asarray(st["var"]), rtol=1e-5, atol=1e-6)


def test_loss_loss_and_iou_decode_match_jax():
    from dal3d_tpu.models.heads import mg_loss_head as jh
    from dal3d_tpu_torch.models.heads import mg_loss_head as th

    rng = np.random.RandomState(8)
    p = [rng.randn(2, 1).astype(np.float32), rng.randn(2, 3).astype(np.float32)]
    ref = jh.compute_loss_loss(jnp.float32(1.5), [jnp.asarray(x) for x in p], 2)
    got = th.compute_loss_loss(torch.tensor(1.5), [t(x) for x in p], 2)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)  # f32 sums in two orders
    x = (rng.randn(50) * 3).astype(np.float32)
    for flavour in ("smooth_l1", "sigmoid"):
        np.testing.assert_allclose(th.decode_iou_preds(t(x), flavour).numpy(),
                                   np.asarray(jh.decode_iou_preds(jnp.asarray(x), flavour)),
                                   rtol=1e-6, atol=1e-7)
