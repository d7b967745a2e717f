"""The overfit twin (tests/test_torch_accuracy.py) through the port's CLIs,
on the CPU at its own tiny size: what ``chip_smoke.py`` phase 16 runs on the
card with the twin's trained checkpoint, the PPAL / CALD pre-pass CLIs on
the card against ``--cpu``.

- ``twin_config`` builds ``make_bundle``'s model: the same module names and
  shapes, and the same test settings;
- the pool that ``write_scene_pool`` writes loads exactly the scene's
  points through the config's val pipeline and loader;
- ``ppal_pred_list`` on that pool and a checkpoint of the twin's seeded
  weights gives the twin's own predict on the scene, bit for bit.
"""
import numpy as np
import pytest
import torch

from dal3d_tpu_torch.data import DataLoader, NuScenesDataset
from dal3d_tpu_torch.models.builder import build_detector
from dal3d_tpu_torch.runtime.checkpoint import save_checkpoint
from dal3d_tpu_torch.runtime.steps import make_predict_step
from dal3d_tpu_torch.tools import ppal_pred_list
from test_torch_accuracy import (make_bundle, scene_batch, twin_config, write_scene_pool,
                                 write_twin_config)
from test_torch_camera_branch import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    root = tmp_path_factory.mktemp("twin")
    return str(root), write_scene_pool(str(root))


def test_twin_config_builds_the_twin_model(pool):
    built = build_detector(twin_config(pool[1]), device="cpu", seed=0)
    twin = make_bundle("cpu")
    a, b = built.model.state_dict(), twin.model.state_dict()
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape for k in a)
    assert built.test_cfg == twin.test_cfg and built.num_classes == twin.num_classes
    assert built.voxel_cfg == twin.voxel_cfg


def test_scene_pool_loads_the_scene_points(pool):
    cfg = twin_config(pool[1])
    val = cfg["data"]["val"]
    ds = NuScenesDataset(info_path=val["info_path"], nsweeps=1, class_names=["car"],
                         pipeline=[dict(s) for s in val["pipeline"]], tasks=cfg["tasks"],
                         max_points=cfg["max_points"], voxelize_host=None, test_mode=True)
    batch = next(iter(DataLoader(ds, 2, shuffle=False, drop_last=False, prefetch=0)))
    _, scene = scene_batch()
    np.testing.assert_array_equal(batch["points"], scene["points"])
    np.testing.assert_array_equal(batch["points_valid"], scene["points_valid"])


def test_pred_list_cli_gives_the_twin_predict(pool):
    root, info = pool
    twin = make_bundle("cpu")
    work = f"{root}/work"
    save_checkpoint(work, twin.model, epoch=1)
    cfg = write_twin_config(f"{root}/twin.py", info,
                            selector=dict(type="PPALSelector", budget=3, infos_origin=info,
                                          buffer_file=f"{root}/buffer.json"))
    got = ppal_pred_list.main([cfg, "--checkpoint", work, "--out", f"{root}/pred.pkl", "--cpu"])
    _, scene = scene_batch()
    with torch.no_grad():
        want = make_predict_step(twin)({"points": scene["points"],
                                        "points_valid": scene["points_valid"]})
    assert list(got) == ["twin0", "twin1"]
    for b, token in enumerate(got):
        for k in ("box3d_lidar", "scores", "label_preds", "det_valid"):
            np.testing.assert_array_equal(got[token][k], want[k][b].numpy(), err_msg=k)
