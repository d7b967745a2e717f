"""The port's reference-checkpoint loader for BEVFusion
(dal3d_tpu_torch/models/bevfusion/convert_bevfusion.py and
tools/convert_bevfusion.py) against the route through the JAX package on the
CPU.

On seeded mmdet3d-named weights built as tests/test_convert_bevfusion.py
builds them (a lidar-only TransFusion-L tree at small widths), the port's
converter is bit-equal to JAX's ``convert_bevfusion_state_dict`` followed by
the weights bridge ``bevfusion_flax_to_state_dict``, tensor for tensor, and
covers every parameter and buffer of the port's model. Camera keys into a
model without the camera branch raise, as JAX's ``apply_torch_init`` does
for keys its tree lacks; a camera + lidar checkpoint converts bit-equal to
JAX's route (tests/test_torch_convert_swin.py). The reference's
``heads.map.*`` (its segmentation head) are left unconverted, as JAX's
converter leaves them: a seg model keeps its own seg head; a CenterPoint
model refuses the TransFusion tensors. The npz of the conversion CLI loads into the config's
model with the written values; an unknown key or a shape mismatch raises;
without --cpu on a box with no GPU the CLI raises."""
import numpy as np
import pytest
import torch

from dal3d_tpu.models.bevfusion.convert_bevfusion import (
    convert_bevfusion_state_dict as jax_convert)
from dal3d_tpu_torch.models.bevfusion.convert_bevfusion import (apply_torch_init_bevfusion,
                                                                convert_bevfusion_state_dict)
from dal3d_tpu_torch.models.builder import build_bevfusion
from dal3d_tpu_torch.models.convert_flax import bevfusion_flax_to_state_dict
from dal3d_tpu_torch.models.convert_second import save_raw_state_dict_npz
from dal3d_tpu_torch.tools import convert_bevfusion as convert_cli
from test_convert_bevfusion import D_HID, DEC_CH, ENC, HEADS, NC, P_PROP, _rnd_sd

MODEL = dict(type="BEVFusion", with_camera=False, num_classes=NC, num_proposals=P_PROP,
             decoder_channels=DEC_CH, decoder_layer_nums=(2, 2),
             neck_out_channels=(D_HID * 2, D_HID * 2), voxel_caps=(41 * 16 * 16, 4096, 1024, 512),
             encoder_channels=ENC, hidden_channel=D_HID, num_heads=HEADS, ffn_channel=D_HID * 2)
VG = dict(range=[-2.0, -2.0, -1.025, 2.0, 2.0, 1.025], voxel_size=[0.25, 0.25, 0.05],
          max_points_in_voxel=5, max_voxel_num=41 * 16 * 16)


def _cfg(**model):
    return {"model": {**MODEL, **model}, "voxel_generator": dict(VG),
            "test_cfg": dict(out_size_factor=8, voxel_size=[0.25, 0.25], pc_range=[-2.0, -2.0])}


@pytest.fixture(scope="module")
def reference():
    return _rnd_sd(np.random.RandomState(0))


def test_converter_bit_equal_to_the_jax_route(reference):
    model = build_bevfusion(_cfg(), device="cpu").model
    got = convert_bevfusion_state_dict(reference, model)
    params, stats = jax_convert(reference, num_heads=HEADS)
    ref = bevfusion_flax_to_state_dict({"params": params, "batch_stats": stats}, model)
    assert set(got) == set(ref) == set(model.state_dict())
    for k, v in ref.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], v), k
    prefixed = {f"module.{k}": v for k, v in reference.items()}  # a DDP checkpoint
    again = convert_bevfusion_state_dict(prefixed, model)
    assert all(torch.equal(again[k], v) for k, v in got.items())


def test_camera_keys_are_refused(reference):
    """...by a lidar-only model, whose tree has no place for them."""
    model = build_bevfusion(_cfg(), device="cpu").model
    for key in ("encoders.camera.backbone.patch_embed.proj.weight", "fuser.0.weight"):
        sd = dict(reference)
        sd[key] = np.zeros((4, 4), np.float32)
        with pytest.raises(KeyError, match="no camera branch"):
            convert_bevfusion_state_dict(sd, model)


def test_cli_npz_loads_into_the_model(reference, tmp_path, monkeypatch):
    pth, npz = str(tmp_path / "ref.pth"), str(tmp_path / "ref.npz")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in reference.items()}}, pth)
    cfg = tmp_path / "cfg.py"
    cfg.write_text("".join(f"{k} = {v!r}\n" for k, v in _cfg().items()))
    flax = convert_cli.main([pth, npz, "--config", str(cfg), "--cpu"])
    assert len(flax["params"]) > 100 and len(flax["batch_stats"]) > 40
    model = build_bevfusion(_cfg(), device="cpu", seed=5).model
    apply_torch_init_bevfusion(model, npz)
    want = convert_bevfusion_state_dict(reference, model)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    wider = build_bevfusion(_cfg(decoder_channels=(24, 32)), device="cpu").model
    with pytest.raises((ValueError, KeyError)):
        apply_torch_init_bevfusion(wider, npz)
    sd = dict(reference)
    del sd["heads.object.prediction_heads.0.vel.1.bias"]
    save_raw_state_dict_npz(sd, str(tmp_path / "cut.npz"))
    with pytest.raises(KeyError):
        apply_torch_init_bevfusion(model, str(tmp_path / "cut.npz"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert_cli.main([pth, str(tmp_path / "gpu.npz")])


def test_map_head_keys_are_left_as_jax_leaves_them(reference, tmp_path):
    sd = dict(reference)
    rng = np.random.RandomState(3)
    for k, shape in (("heads.map.classifier.0.weight", (16, 32, 3, 3)),
                     ("heads.map.classifier.1.running_mean", (16,)),
                     ("heads.map.classifier.6.bias", (6,))):
        sd[k] = rng.randn(*shape).astype(np.float32)
    params, stats = jax_convert(sd, num_heads=HEADS)
    assert not any("map" in k.lower() or "Segmentation" in k for k in list(params) + list(stats))
    assert set(params) == set(jax_convert(reference, num_heads=HEADS)[0])
    seg = build_bevfusion(_cfg(with_map_seg=True), device="cpu", seed=5).model
    got = convert_bevfusion_state_dict(sd, seg)
    ref = bevfusion_flax_to_state_dict({"params": params, "batch_stats": stats}, seg)
    assert set(got) == set(ref) == {k for k in seg.state_dict() if not k.startswith("seg_head.")}
    assert all(torch.equal(got[k], v) for k, v in ref.items())
    before = {k: v.clone() for k, v in seg.state_dict().items() if k.startswith("seg_head.")}
    save_raw_state_dict_npz(sd, str(tmp_path / "map.npz"))
    apply_torch_init_bevfusion(seg, str(tmp_path / "map.npz"))
    after = seg.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())  # the seg head is kept
    assert torch.equal(after["head.shared_conv.weight"], got["head.shared_conv.weight"])
    center = build_bevfusion(_cfg(head="centerpoint"), device="cpu").model
    with pytest.raises(KeyError, match="TransFusion"):
        convert_bevfusion_state_dict(sd, center)
