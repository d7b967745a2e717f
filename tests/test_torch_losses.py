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
