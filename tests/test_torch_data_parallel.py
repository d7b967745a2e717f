"""Data parallelism of the port (dal3d_tpu_torch/parallel) in a ``gloo`` world
of 2 CPU processes against one process on the global batch, and the
gathered pool scores against JAX's ``data_parallel_predict`` on a 2-device
CPU mesh.

One world runs every check (tests/torch_dist_worker.py), and one process
with no group the same checks on the global batch, while this process runs
JAX; each rank holds 1 row of a 2-row global batch (2 of 4 in the norms and
the estimator). Tolerances, where the two sum the same numbers in another
order:

- the synced norms (``MaskedBatchNorm``, ``BatchNorm2d``, ``BatchNormLast``):
  outputs, input gradients, running statistics and the weight and bias
  gradients summed over the ranks within 1e-5 of their scale;
- the small CBGS train step (tests/torch_port_utils.py::small_cfg, banded
  and gather engines): loss and its parts within 1e-5 relative,
  ``num_pos`` equal, the grad norm within 1e-3 relative, every averaged
  gradient within 1e-3 of its tensor's scale (a one-ulp move of the voxel
  features moves the one-process step's box-head gradients by 1.6e-4 of
  their scale; the conv biases in front of a
  batch norm have no gradient but rounding noise: held below 1e-6 of the
  largest gradient, as the one-process one is), the running statistics
  within 1e-5 of scale; the parameters after AdamW within 1e-6 wherever the
  one-process gradient is above 1e-4 of its tensor's scale, and within
  2 lr + 1e-6 elsewhere (Adam's first update is lr x sign(g), so a gradient
  at rounding level may flip it); with a group of one, every number
  bit-equal to no group (tests/test_torch_train_step.py holds the
  one-process step against JAX's);
- the TransFusion and estimator losses: the mean over the ranks of their
  losses within 1e-5 relative of the one-process loss, each rank's
  gradient over the world size within 1e-5 of the one-process gradient's
  scale on its rows (the estimator's weight gradients averaged over the
  ranks), so every normaliser counts the global batch;
- ``active_select`` and ``dist_test`` through their ``main`` on a 5-frame
  synthetic pool (one sweep, so the loader draws nothing at random): the
  buffer JSON and the subset pkl byte-equal to the one-process run's, the
  pool scores and the ``--out`` detections bit-equal (each rank forwards
  the same 2 frames as one process does), and the gathered embeddings within
  1e-4 of JAX's ``data_parallel_predict`` on 2 CPU devices (f32 in another
  summation order; one JAX compile, a predict);
- a ``--batch_size`` that does not divide by the world is refused.
"""
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dal3d_tpu.data import DataLoader as JaxLoader
from dal3d_tpu.data import NuScenesDataset as JaxDataset
from dal3d_tpu.models.builder import build_detector as jax_build
from dal3d_tpu.parallel.mesh import data_parallel_predict as jax_data_parallel_predict
from dal3d_tpu.parallel.mesh import make_mesh
from dal3d_tpu.runtime.steps import make_predict_step as jax_make_predict_step
from dal3d_tpu.utils.config import Config as JaxConfig
from dal3d_tpu_torch.data.datasets.synthetic import DEFAULT_CLASSES, make_synthetic_nuscenes
from dal3d_tpu_torch.models.builder import build_detector
from dal3d_tpu_torch.models.convert_flax import load_flax_variables
from dal3d_tpu_torch.runtime.checkpoint import save_checkpoint
from dal3d_tpu_torch.utils.fileio import dump, load
from test_torch_camera_branch import few_threads  # noqa: F401
from test_torch_predict import _randomize
from torch_port_utils import small_cfg
import torch_dist_worker as w

pytestmark = pytest.mark.usefixtures("few_threads")

N_FRAMES, BUDGET, SEED = 5, 2, 11
PIPELINE = [dict(type="LoadPointCloudFromFile", dataset="NuScenesDataset"),
            dict(type="LoadPointCloudAnnotations", with_bbox=True),
            dict(type="Preprocess", cfg=dict(mode="val", shuffle_points=False)),
            dict(type="ReformatFixedShape")]
NORMS = ("masked", "2d", "last")
IMPLS = ("banded", "gather")


def _pool_cfg(info_path):
    cfg = small_cfg("float32")
    cfg["voxel_generator"].update(max_voxel_num=1500, bf16=False)
    cfg["max_points"] = 6000
    cfg["data"] = dict(samples_per_gpu=2, val=dict(
        type="NuScenesDataset", root_path="", info_path=info_path, test_mode=True, nsweeps=1,
        class_names=DEFAULT_CLASSES, pipeline=PIPELINE))
    return cfg


def _write_run(tmp, cfg, name, work):
    """A CLI run's directory: its infos copy (the subset pkl lands beside
    it), an empty buffer and a config with a FeatureSelector."""
    d = os.path.join(tmp, name)
    os.makedirs(d)
    shutil.copy(cfg["data"]["val"]["info_path"], os.path.join(d, "infos.pkl"))
    dump({"0": []}, os.path.join(d, "buffer.json"))
    cfg = dict(cfg, selector=dict(
        type="FeatureSelector", budget=BUDGET, buffer_file=os.path.join(d, "buffer.json"),
        infos_origin=os.path.join(d, "infos.pkl"), pred_store_file=os.path.join(d, "pred.npz"),
        distance_type="l2"))
    path = os.path.join(d, "cfg.py")
    with open(path, "w") as f:
        for k, v in cfg.items():
            f.write(f"{k} = {v!r}\n")
    return dict(dir=d, cfg=path, work=work, out=os.path.join(d, "dets.pkl"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, few_threads):  # noqa: F811
    """Start the world, compute the one-process references meanwhile, join."""
    tmp = str(tmp_path_factory.mktemp("data_parallel"))
    info = make_synthetic_nuscenes(os.path.join(tmp, "nusc"), n_frames=N_FRAMES, n_logs=2,
                                   points_per_frame=3000, range_xy=6.0, seed=4)
    cfg = _pool_cfg(info)
    # JAX's model and seeded variables, carried into a port checkpoint
    jb = jax_build(JaxConfig(cfg))
    dataset = JaxDataset(info_path=info, nsweeps=1, class_names=DEFAULT_CLASSES, pipeline=PIPELINE,
                         tasks=cfg["tasks"], max_points=cfg["max_points"],
                         voxelize_host=dict(cfg["voxel_generator"]), test_mode=True)
    sample = next(iter(JaxLoader(dataset, 4, shuffle=False, drop_last=False, prefetch=0)))
    voxels = tuple(jnp.asarray(sample[k]) for k in ("voxel_features", "voxel_coords",
                                                    "voxel_valid"))
    dummy = (jnp.zeros((4, 1, 5), jnp.float32), jnp.zeros((4, 1), bool))
    shapes = jax.eval_shape(lambda: jb.model.init(jax.random.PRNGKey(0), *dummy, False,
                                                  voxels=voxels))
    variables = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape), shapes),
                           np.random.RandomState(2))
    bundle = build_detector(cfg, device="cpu")
    load_flax_variables(bundle.model, variables)
    work = os.path.join(tmp, "work")
    save_checkpoint(work, bundle.model, epoch=1)
    one, world = (_write_run(tmp, cfg, name, work) for name in ("one", "world"))

    checks = ([(f"norm_{k}", "norm_step", {"kind": k}) for k in NORMS]
              + [(f"step_{i}", "cbgs_step", {"impl": i}) for i in IMPLS]
              + [("transfusion", "transfusion_share", {}), ("estimator", "estimator_share", {}),
                 ("clis", "run_clis", dict(cfg=world["cfg"], work=work, out=world["out"],
                                           seed=SEED)),
                 ("batch_size", "refused", dict(argv=[world["cfg"], "--cpu",
                                                      "--batch_size", "3"]))])
    ref_checks = [c for c in checks if c[0] not in ("clis", "batch_size")] + [
        ("clis", "run_clis", dict(cfg=one["cfg"], work=work, out=one["out"], seed=SEED))]
    handles = [w.start_world(2, os.path.join(tmp, "world2"), checks),
               w.start_world(1, os.path.join(tmp, "reference"), ref_checks, group=False)]
    try:
        # JAX's pool scoring over a 2-device mesh, global batches of 4
        predict = jax_data_parallel_predict(jax_make_predict_step(jb),
                                            make_mesh(n_data=2, devices=jax.devices()[:2]))
        emb = []
        for batch in JaxLoader(dataset, 4, shuffle=False, drop_last=False, prefetch=0):
            out = predict(variables["params"], variables["batch_stats"],
                          {k: batch[k] for k in ("voxel_features", "voxel_coords",
                                                 "voxel_valid")})
            emb.append(np.asarray(out["embedding"]))
        jax_emb = np.concatenate(emb)[:N_FRAMES]
    finally:
        ranks, (ref,) = (w.join_world(h, timeout=420) for h in handles)
    ref = {name: w.result(ref, name) for name, _, _ in ref_checks}
    return dict(ranks=ranks, ref=ref, one=one, world=world, jax_emb=jax_emb)


def _scale_close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


@pytest.mark.parametrize("kind", NORMS)
def test_synced_norm_matches_one_process(runs, kind):
    ref = runs["ref"][f"norm_{kind}"]
    got = [w.result(r, f"norm_{kind}") for r in runs["ranks"]]
    for k in ("y", "x_grad"):
        _scale_close(np.concatenate([g[k] for g in got]), ref[k], 1e-5, k)
    for k in ("w_grad", "b_grad"):
        _scale_close(sum(g[k] for g in got), ref[k], 1e-5, k)
    for g in got:
        for k in ("running_mean", "running_var"):
            _scale_close(g[k], ref[k], 1e-5, k)


@pytest.mark.parametrize("impl", IMPLS)
def test_cbgs_train_step_matches_one_process(runs, impl):
    for r in runs["ranks"]:
        w.check_step(w.result(r, f"step_{impl}"), runs["ref"][f"step_{impl}"])


def test_world_of_one_gives_the_bits_of_no_group(runs, tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
                            world_size=1)
    try:
        got = w.cbgs_step(0, 1, "banded")
    finally:
        dist.destroy_process_group()
    assert w.same_step(got, runs["ref"]["step_banded"])


def test_transfusion_normalisers_count_the_global_batch(runs):
    ref = runs["ref"]["transfusion"]
    got = [w.result(r, "transfusion") for r in runs["ranks"]]
    world = len(got)
    loss = sum(g["logs"]["loss"] for g in got) / world
    assert abs(loss - ref["logs"]["loss"]) <= 1e-5 * abs(ref["logs"]["loss"])
    assert sum(g["logs"]["num_matched"] for g in got) == ref["logs"]["num_matched"]
    # the two frames match different counts, so a per-rank normaliser would differ
    assert len({g["logs"]["num_matched"] for g in got}) == 2
    b = w.TF_B // world
    for k in w.TF_KEYS:
        for r, g in enumerate(got):
            _scale_close(g["grads"][k] / world, ref["grads"][k][r * b:(r + 1) * b], 1e-5, k)


def test_estimator_normaliser_counts_the_global_batch(runs):
    ref = runs["ref"]["estimator"]
    got = [w.result(r, "estimator") for r in runs["ranks"]]
    world = len(got)
    assert abs(sum(g["loss"] for g in got) / world - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    for n, v in ref["grads"].items():
        _scale_close(sum(g["grads"][n] for g in got) / world, v, 1e-5, n)


def test_active_select_files_are_byte_equal_to_one_process(runs):
    one, world = runs["one"]["dir"], runs["world"]["dir"]
    for name in ("buffer.json", f"infos_{BUDGET}.pkl"):
        a = open(os.path.join(one, name), "rb").read()
        assert a == open(os.path.join(world, name), "rb").read(), name
    assert len(load(os.path.join(one, "buffer.json"))[str(BUDGET)]) >= 1
    a, b = np.load(os.path.join(one, "pred.npz")), np.load(os.path.join(world, "pred.npz"))
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_gathered_embeddings_match_jax_data_parallel_predict(runs):
    got = np.load(os.path.join(runs["world"]["dir"], "pred.npz"))["embedding"]
    assert got.shape == runs["jax_emb"].shape == (N_FRAMES, 512)
    assert float(np.abs(got).max()) > 0
    np.testing.assert_allclose(got, runs["jax_emb"], rtol=1e-4, atol=1e-4)


def test_dist_test_detections_are_bit_equal_to_one_process(runs):
    with open(runs["one"]["out"], "rb") as f:
        a = pickle.load(f)
    with open(runs["world"]["out"], "rb") as f:
        b = pickle.load(f)
    assert list(a) == list(b) and len(a) == N_FRAMES
    for token in a:
        for k in a[token]:
            assert np.array_equal(a[token][k], b[token][k]), (token, k)
    r0, r1 = (w.result(r, "clis") for r in runs["ranks"])
    assert r1 is None  # rank 0 evaluates
    assert r0["kitti_style"] == runs["ref"]["clis"]["kitti_style"]


def test_batch_size_that_does_not_split_is_refused(runs):
    for r in runs["ranks"]:
        msg = w.result(r, "batch_size")
        assert msg is not None and "--batch_size 3" in msg and "2 ranks" in msg
