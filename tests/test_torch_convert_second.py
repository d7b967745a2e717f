"""The port's det3d checkpoint loader (dal3d_tpu_torch/models/convert_second.py)
against the JAX package's two-bridge route, and ``--torch_init`` through the
port's CLIs on the CPU.

- The seeded det3d-named state_dicts of tests/oracle_utils.py, at both of
  its scales, mapped straight to the port's names are bit-equal to the route
  through flax (dal3d_tpu/models/convert_second.py, then
  dal3d_tpu_torch/models/convert_flax.py::flax_to_state_dict), and cover
  every tensor of the port's FPNVoxelNet at that scale; a DDP ``module.``
  prefix is stripped; ``to_det3d_state_dict`` is the exact inverse.
- The raw-npz pair round-trips and reads JAX's files (and JAX reads the
  port's); ``apply_torch_init`` refuses unknown keys and shape mismatches,
  keeps and logs what the checkpoint does not cover; a non-FPN
  (``SpMiddleResNetFHD``) checkpoint converts bit-equal to JAX's route, a
  foreign one is refused with its reason.
- ``tools/convert_second.py`` writes the npz from a .pth and validates it on
  a config's model; ``train --torch_init`` starts from those weights."""
import logging
import os

import numpy as np
import pytest
import torch

from dal3d_tpu.models.convert_second import convert_second_state_dict as jax_convert
from dal3d_tpu.models.convert_second import load_raw_state_dict_npz as jax_load_npz
from dal3d_tpu.models.convert_second import save_raw_state_dict_npz as jax_save_npz
from dal3d_tpu_torch.data.datasets.synthetic import make_synthetic_nuscenes
from dal3d_tpu_torch.models import convert_second as cs
from dal3d_tpu_torch.models.builder import build_detector
from dal3d_tpu_torch.models.convert_flax import flax_to_state_dict
from dal3d_tpu_torch.models.detectors.voxelnet import FPNVoxelNet
from dal3d_tpu_torch.runtime.trainer import Trainer
from dal3d_tpu_torch.tools import convert_second as convert_cli
from dal3d_tpu_torch.tools import train
from dal3d_tpu_torch.utils.config import Config
from oracle_utils import (DS_FILTERS, DS_STRIDES, LAYER_NUMS, NUM_CLASSES, US_FILTERS,
                          US_STRIDES, VCFG, rnd_state_dict)
from test_torch_trainer import _write_cfg


def oracle_model():
    return FPNVoxelNet(
        VCFG.sparse_shape, num_classes=NUM_CLASSES, rpn_layer_nums=LAYER_NUMS,
        rpn_ds_strides=DS_STRIDES, rpn_ds_filters=DS_FILTERS, rpn_us_strides=US_STRIDES,
        rpn_us_filters=US_FILTERS, brick_widths=(16, 8, 4, 2, 2),
        banded_caps=(12032, 2048, 512, 256, 256)).eval()


@pytest.mark.parametrize("normalized", [False, True])
def test_port_loader_is_bit_equal_to_the_two_bridges(normalized):
    sd = rnd_state_dict(np.random.RandomState(0), normalized=normalized)
    model = oracle_model()
    params, stats = jax_convert(sd, nested_l0=True)
    want = flax_to_state_dict({"params": params, "batch_stats": stats}, model)
    got = cs.convert_second_state_dict(sd)
    assert set(got) == set(want) == set(model.state_dict())
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and got[k].shape == v.shape, k
        assert torch.equal(got[k].view(torch.int32), v.view(torch.int32)), k
    # DDP's prefix, and torch tensors as values
    ddp = {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}
    assert all(torch.equal(a, b) for a, b in
               zip(cs.convert_second_state_dict(ddp).values(), got.values()))
    # the inverse gives back the det3d names, layouts and values
    back = cs.to_det3d_state_dict(got)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_npz_round_trip_and_both_packages_read_each_other(tmp_path):
    sd = rnd_state_dict(np.random.RandomState(1))
    port_npz, jax_npz = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    cs.save_raw_state_dict_npz(sd, port_npz)
    jax_save_npz(sd, jax_npz)
    for loaded in (cs.load_raw_state_dict_npz(port_npz), cs.load_raw_state_dict_npz(jax_npz),
                   jax_load_npz(port_npz)):
        assert set(loaded) == set(sd)
        for k, v in sd.items():
            np.testing.assert_array_equal(loaded[k], v, err_msg=k)


def test_apply_torch_init_checks_and_logs(tmp_path, caplog):
    sd = rnd_state_dict(np.random.RandomState(2))
    path = str(tmp_path / "w.npz")
    cs.save_raw_state_dict_npz(sd, path)
    model = oracle_model()
    cs.apply_torch_init(model, path)
    want = cs.convert_second_state_dict(sd)
    assert all(torch.equal(model.state_dict()[k], v) for k, v in want.items())

    # a checkpoint that covers less: the rest keeps its values and is logged
    part = {k: v for k, v in sd.items() if not k.startswith("bbox_head.tasks.1.")}
    cs.save_raw_state_dict_npz(part, path)
    fresh = oracle_model()
    before = fresh.head.tasks[1].conv_cls.weight.clone()
    logger = logging.getLogger("torch_init_test")
    with caplog.at_level(logging.INFO, logger="torch_init_test"):
        cs.apply_torch_init(fresh, path, logger=logger)
    assert torch.equal(fresh.head.tasks[1].conv_cls.weight, before)
    assert "4 model tensors not in the checkpoint keep their values" in caplog.text

    # a tensor the model does not have; a shape the model does not have
    extra = dict(sd, **{"bbox_head.tasks.2.conv_box.weight": np.zeros((4, 128, 1, 1)),
                        "bbox_head.tasks.2.conv_box.bias": np.zeros(4),
                        "bbox_head.tasks.2.conv_cls.weight": np.zeros((4, 128, 1, 1)),
                        "bbox_head.tasks.2.conv_cls.bias": np.zeros(4)})
    cs.save_raw_state_dict_npz(extra, path)
    with pytest.raises(KeyError, match="not in the model"):
        cs.apply_torch_init(oracle_model(), path)
    bad = dict(sd)
    bad["neck.blocks.0.1.weight"] = bad["neck.blocks.0.1.weight"][:, :128]
    cs.save_raw_state_dict_npz(bad, path)
    with pytest.raises(ValueError, match="shape mismatch at neck.blocks.0.0.weight"):
        cs.apply_torch_init(oracle_model(), path)


def _non_fpn(sd):
    """An FPN det3d state_dict re-indexed as the non-FPN ``SpMiddleResNetFHD``'s
    one ``backbone.middle_conv`` Sequential: L0 keeps its indices, stage s's
    blocks / strided conv / BN (0, 1, 2, 3) move to 3 + 5s + (0, 1, 2, 3)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("backbone.middle_conv0."):
            k = k.replace("backbone.middle_conv0.", "backbone.middle_conv.")
        elif k.startswith("backbone.middle_conv"):
            s, i, rest = k[len("backbone.middle_conv"):].split(".", 2)
            k = f"backbone.middle_conv.{3 + 5 * int(s) + int(i)}.{rest}"
        out[k] = v
    return out


def test_non_fpn_checkpoint_converts_as_jax_does():
    sd = _non_fpn(rnd_state_dict(np.random.RandomState(3)))
    assert not any(k.startswith("backbone.middle_conv0.") for k in sd)
    assert "backbone.middle_conv.21.running_var" in sd
    model = oracle_model()
    params, stats = jax_convert(sd, nested_l0=True)
    want = flax_to_state_dict({"params": params, "batch_stats": stats}, model)
    got = cs.convert_second_state_dict(sd)
    assert set(got) == set(want) == set(model.state_dict())
    for k, v in want.items():
        assert torch.equal(got[k].view(torch.int32), v.view(torch.int32)), k
    model.load_state_dict(got, strict=True)


def test_foreign_checkpoints_are_refused():
    sd = rnd_state_dict(np.random.RandomState(3))
    with pytest.raises(KeyError, match="no backbone.middle_conv0"):
        cs.convert_second_state_dict({k: v for k, v in sd.items()
                                      if not k.startswith("backbone.")})
    with pytest.raises(KeyError, match="no neck.blocks"):
        cs.convert_second_state_dict({k: v for k, v in sd.items() if not k.startswith("neck.")})
    with pytest.raises(KeyError, match="no bbox_head"):
        cs.convert_second_state_dict({k: v for k, v in sd.items()
                                      if not k.startswith("bbox_head.")})
    with pytest.raises(KeyError, match="not a tensor of the port"):
        cs.to_det3d_state_dict({"encoder.stem.weight": torch.zeros(27, 5, 16)})


def test_convert_cli_and_train_torch_init(tmp_path):
    """A det3d .pth of the small config's model -> the CLI's npz (validated on
    the config's model) -> ``train --torch_init`` starts from its weights."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        info = make_synthetic_nuscenes(str(tmp_path), n_frames=4, n_logs=2,
                                       points_per_frame=3000, range_xy=6.0, max_boxes=6, seed=5)
        work = str(tmp_path / "work")
        cfg = _write_cfg(tmp_path / "cfg.py", info, work)
        src = build_detector(Config.fromfile(cfg), device="cpu", seed=11).model.state_dict()
        pth, npz = str(tmp_path / "det3d.pth"), str(tmp_path / "det3d.npz")
        torch.save({"state_dict": {f"module.{k}": torch.from_numpy(v)
                                   for k, v in cs.to_det3d_state_dict(src).items()}}, pth)
        mapped = convert_cli.main([pth, npz, "--config", cfg, "--cpu"])
        assert all(torch.equal(mapped[k], v) for k, v in src.items())

        # the weights the run starts from: captured as the trainer binds them
        seen = {}
        orig = Trainer.run

        def run(self, *a, **k):
            seen.update({k_: v.clone() for k_, v in self.bundle.model.state_dict().items()})
            return orig(self, *a, **k)

        Trainer.run = run
        try:
            tr = train.main([cfg, "--work_dir", work, "--epochs", "1", "--no_validate",
                             "--cpu", "--seed", "0", "--torch_init", npz])
        finally:
            Trainer.run = orig
        assert tr.step >= 2
        assert all(torch.equal(seen[k], v) for k, v in src.items())
        log = open(os.path.join(work, "train.log")).read()
        assert f"warm-started from converted torch checkpoint {npz}" in log
    finally:
        torch.set_num_threads(n)
