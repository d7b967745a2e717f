"""The slice as a whole: pool scoring -> selection, PyTorch port (CPU, plain
versions, through its CLI entry) against the JAX package on the same
synthetic pool, weights and seeds.

JAX: dataset + loader + predict step -> ``run_pool_scoring`` ->
``FeatureSelector`` / ``EntropySelector``. Port:
``dal3d_tpu_torch.tools.active_select.main([... "--cpu"])`` with the same
weights carried across by ``convert_flax`` and saved with
``save_checkpoint``. Embeddings and entropies agree within 1e-4 (f32, another
summation order), the selected indices are equal."""
import os
import random
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu import selectors as jsel
from dal3d_tpu.data import DataLoader as JaxLoader
from dal3d_tpu.data import NuScenesDataset as JaxDataset
from dal3d_tpu.models.builder import build_detector as jax_build
from dal3d_tpu.runtime.steps import make_predict_step as jax_make_predict_step
from dal3d_tpu.utils.config import Config as JaxConfig
from dal3d_tpu_torch.data.datasets.synthetic import make_synthetic_nuscenes
from dal3d_tpu_torch.models.builder import build_detector
from dal3d_tpu_torch.models.convert_flax import load_flax_variables
from dal3d_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
from dal3d_tpu_torch.tools import active_select
from dal3d_tpu_torch.utils.fileio import dump, load
from test_torch_predict import _randomize
from torch_port_utils import small_cfg

N_FRAMES, BUDGET, SEED = 7, 2, 11
PIPELINE = [
    dict(type="LoadPointCloudFromFile", dataset="NuScenesDataset"),
    dict(type="LoadPointCloudAnnotations", with_bbox=True),
    dict(type="Preprocess", cfg=dict(mode="val", shuffle_points=False)),
    dict(type="ReformatFixedShape"),
]


def _cfg(info_path):
    cfg = small_cfg("float32")
    cfg["voxel_generator"].update(max_voxel_num=1500, bf16=False)
    cfg["max_points"] = 40000
    cfg["data"] = dict(samples_per_gpu=2, workers_per_gpu=1,
                       val=dict(type="NuScenesDataset", root_path="", info_path=info_path,
                                test_mode=True, nsweeps=10, class_names=["car"],
                                pipeline=PIPELINE))
    return cfg


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The pool, the JAX model's variables, and JAX's pool scoring."""
    tmp = tmp_path_factory.mktemp("slice")
    info_path = make_synthetic_nuscenes(str(tmp / "nusc"), n_frames=N_FRAMES, n_logs=2,
                                        points_per_frame=3000, range_xy=6.0, seed=4)
    cfg = _cfg(info_path)
    jb = jax_build(JaxConfig(cfg))
    dataset = JaxDataset(info_path=info_path, nsweeps=10, class_names=["car"], pipeline=PIPELINE,
                         tasks=cfg["tasks"], max_points=cfg["max_points"],
                         voxelize_host=dict(cfg["voxel_generator"]), test_mode=True)
    np.random.seed(SEED)
    sample = next(iter(JaxLoader(dataset, 2, shuffle=False, drop_last=False, prefetch=0)))
    voxels = tuple(jnp.asarray(sample[k]) for k in ("voxel_features", "voxel_coords",
                                                    "voxel_valid"))
    dummy = (jnp.zeros((2, 1, 5), jnp.float32), jnp.zeros((2, 1), bool))
    shapes = jax.eval_shape(lambda: jb.model.init(jax.random.PRNGKey(0), *dummy, False,
                                                  voxels=voxels))
    variables = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape), shapes),
                           np.random.RandomState(2))
    predict = jax_make_predict_step(jb)

    def score_fn(batch):
        return predict(variables["params"], variables["batch_stats"],
                       {k: batch[k] for k in ("voxel_features", "voxel_coords", "voxel_valid")})

    jdir = tmp / "jax"
    jdir.mkdir()
    shutil.copy(info_path, jdir / "infos.pkl")
    dump({"0": []}, str(jdir / "buffer.json"))
    np.random.seed(SEED)
    sel = jsel.build_selector(dict(
        type="FeatureSelector", budget=BUDGET, buffer_file=str(jdir / "buffer.json"),
        infos_origin=str(jdir / "infos.pkl"), pred_store_file=str(jdir / "pred.npz"),
        detector=score_fn, dataloader=JaxLoader(dataset, 2, shuffle=False, drop_last=False)))
    scores = sel.run_pool_scoring(str(jdir / "pred.npz"))
    assert int((dataset[0]["voxel_valid"]).sum()) > 200  # the scenes are not empty
    return dict(tmp=tmp, info_path=info_path, cfg=cfg, variables=variables, scores=scores,
                jdir=jdir)


def _jax_select(world, sel_type):
    jdir = world["jdir"]
    dump({"0": []}, str(jdir / "buffer.json"))
    random.seed(SEED)
    sel = jsel.build_selector(dict(
        type=sel_type, budget=BUDGET, buffer_file=str(jdir / "buffer.json"),
        infos_origin=str(jdir / "infos.pkl"), pred_store_file=str(jdir / "pred.npz")))
    sel.select_samples()
    sel.dump_file()
    return (load(str(jdir / "buffer.json")),
            open(jdir / f"infos_{BUDGET}.pkl", "rb").read())


def _write_port_run(world, sel_type, name):
    """Config file, buffer, infos copy and checkpoint of one CLI run."""
    d = world["tmp"] / name
    d.mkdir()
    shutil.copy(world["info_path"], d / "infos.pkl")
    cfg = dict(world["cfg"])
    cfg["selector"] = dict(type=sel_type, budget=BUDGET, buffer_file=str(d / "buffer.json"),
                           infos_origin=str(d / "infos.pkl"),
                           pred_store_file=str(d / "pred.npz"))
    with open(d / "cfg.py", "w") as f:
        for k, v in cfg.items():
            f.write(f"{k} = {v!r}\n")
    bundle = build_detector(world["cfg"], device="cpu")
    load_flax_variables(bundle.model, world["variables"])
    save_checkpoint(str(d / "work"), bundle.model, epoch=3)
    return d


def test_first_round_writes_an_empty_buffer(world):
    d = _write_port_run(world, "FeatureSelector", "first")
    active_select.main([str(d / "cfg.py"), "--cpu"])
    assert load(str(d / "buffer.json")) == {"0": []}
    assert not os.path.exists(d / "pred.npz")


@pytest.mark.parametrize("sel_type", ["FeatureSelector", "EntropySelector"])
def test_cli_round_matches_jax(world, sel_type):
    d = _write_port_run(world, sel_type, sel_type)
    dump({"0": []}, str(d / "buffer.json"))
    active_select.main([str(d / "cfg.py"), "--checkpoint", str(d / "work"), "--cpu",
                        "--seed", str(SEED)])
    got = dict(np.load(d / "pred.npz"))
    ref = world["scores"]
    assert got["embedding"].shape == ref["embedding"].shape == (N_FRAMES, 512)
    np.testing.assert_allclose(got["embedding"], ref["embedding"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["score_entropy"], ref["score_entropy"], rtol=1e-4, atol=1e-4)
    assert float(np.ptp(ref["score_entropy"])) > 0 and float(np.abs(ref["embedding"]).max()) > 0
    np.testing.assert_array_equal(got["det_valid"].sum(1), ref["det_valid"].sum(1))
    buffer, subset = _jax_select(world, sel_type)
    assert load(str(d / "buffer.json")) == buffer
    assert 1 < len(buffer[str(BUDGET)]) < N_FRAMES
    assert open(d / f"infos_{BUDGET}.pkl", "rb").read() == subset
    # a second call finds the scoring cache and needs no checkpoint
    active_select.main([str(d / "cfg.py"), "--cpu", "--seed", str(SEED)])
    assert str(2 * BUDGET) in load(str(d / "buffer.json"))


def test_force_random_matches_jax_draw(world):
    d = _write_port_run(world, "FeatureSelector", "forced")
    dump({"0": []}, str(d / "buffer.json"))
    active_select.main([str(d / "cfg.py"), "--cpu", "--force_random", "--seed", "5"])
    jdir = world["jdir"]
    dump({"0": []}, str(jdir / "buffer.json"))
    random.seed(5)
    sel = jsel.build_selector(dict(type="RandomSelector", budget=BUDGET,
                                   buffer_file=str(jdir / "buffer.json"),
                                   infos_origin=str(jdir / "infos.pkl")))
    sel.select_samples()
    assert load(str(d / "buffer.json"))[str(BUDGET)] == sel.get_selected_samples()[str(BUDGET)]
    assert not os.path.exists(d / "pred.npz")


def test_checkpoint_round_trip(world, tmp_path):
    a = build_detector(world["cfg"], device="cpu", seed=1)
    path = save_checkpoint(str(tmp_path), a.model, epoch=2, meta={"note": "x"})
    save_checkpoint(str(tmp_path), a.model, epoch=10)
    b = build_detector(world["cfg"], device="cpu", seed=2)
    _, meta = load_checkpoint(path, b.model)
    assert meta == {"epoch": 2, "note": "x"}
    for (k, va), (_, vb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(va, vb), k
    assert load_checkpoint(str(tmp_path), b.model)[1]["epoch"] == 10
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"), b.model)
