"""The port's Swin converter (models/bevfusion/convert_swin.py,
tools/convert_swin.py, ``--swin_init``) and the camera keys of its BEVFusion
converter against the route through the JAX package's converters, on the
CPU.

On seeded torch-named state dicts (tests/test_swin_convert.py's builder:
microsoft / timm names and mmdet names) the port's flat flax-named result is
bit-equal to JAX's ``convert_swin_state_dict`` flattened, the npz of the
port's CLI holds exactly those arrays, and it loads into the port's Swin as
the weights bridge carries JAX's tree. A camera + lidar reference checkpoint
(Swin-T, the LSS FPN, DepthLSSTransform with 118 depth bins, the fuser,
and a TransFusion-L of small widths) converts bit-equal to JAX's
``convert_bevfusion_state_dict`` followed by the bridge, covering every
parameter and buffer of the port's model."""
import numpy as np
import pytest
import torch

from dal3d_tpu.models.bevfusion.convert_bevfusion import (
    convert_bevfusion_state_dict as jax_convert_bevfusion)
from dal3d_tpu.models.bevfusion.convert_swin import convert_swin_state_dict as jax_convert_swin
from dal3d_tpu.models.convert_second import flatten_tree
from dal3d_tpu_torch.models.bevfusion.convert_bevfusion import (apply_torch_init_bevfusion,
                                                                convert_bevfusion_state_dict)
from dal3d_tpu_torch.models.bevfusion.convert_swin import convert_swin_state_dict, load_swin_npz
from dal3d_tpu_torch.models.bevfusion.swin import SwinTransformer
from dal3d_tpu_torch.models.builder import build_bevfusion
from dal3d_tpu_torch.models.convert_flax import (bevfusion_flax_to_state_dict,
                                                 swin_flax_to_state_dict)
from dal3d_tpu_torch.models.convert_second import save_raw_state_dict_npz
from dal3d_tpu_torch.tools import convert_swin as swin_cli
from test_convert_bevfusion import HEADS, _rnd_sd
from test_swin_convert import _torch_style_sd
from test_torch_camera_branch import few_threads  # noqa: F401
from test_torch_convert_bevfusion import _cfg

pytestmark = pytest.mark.usefixtures("few_threads")

SWIN_T = dict(embed=96, depths=(2, 2, 6, 2), heads=(3, 6, 12, 24), ws=7, out_indices=(1, 2, 3))
NARROW = dict(embed=24, depths=(2, 2, 2, 2), heads=(1, 2, 2, 4), ws=7, out_indices=(1, 2, 3))


def _port_swin(kw):
    return SwinTransformer(embed_dim=kw["embed"], depths=kw["depths"], num_heads=kw["heads"],
                           window_size=kw["ws"], out_indices=kw["out_indices"])


@pytest.mark.parametrize("mmdet_names", [False, True])
def test_swin_converter_bit_equal_to_jax(mmdet_names, tmp_path):
    sd = _torch_style_sd(**NARROW, mmdet_names=mmdet_names, seed=3)
    got = convert_swin_state_dict(sd, depths=NARROW["depths"], out_indices=(1, 2, 3))
    want = flatten_tree(jax_convert_swin(sd, depths=NARROW["depths"], out_indices=(1, 2, 3)))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and np.array_equal(got[k], v), k
    # the CLI's npz, and --swin_init's loader
    pth, npz = str(tmp_path / "swin.pth"), str(tmp_path / "swin.npz")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, pth)
    swin_cli.main([pth, npz, "--depths", "2,2,2,2"])
    with np.load(npz) as z:
        assert set(z.files) == set(want) and all(np.array_equal(z[k], want[k]) for k in want)
    swin = _port_swin(NARROW)
    assert load_swin_npz(swin, npz) == len(want)
    bridge = swin_flax_to_state_dict(want, swin)
    for k, v in swin.state_dict().items():
        if k in bridge:
            assert np.array_equal(v.numpy(), bridge[k]), k
    other = _port_swin(dict(NARROW, depths=(2, 2, 4, 2)))
    with pytest.raises(KeyError):
        load_swin_npz(other, npz)


def _camera_reference(rng, lidar_channels: int, mmdet_names: bool) -> dict:
    """mmdet3d-named camera keys of a camera + lidar checkpoint: Swin-T
    under ``encoders.camera.backbone`` (microsoft or mmdet names), the LSS
    FPN (in 192 / 384 / 768, out 256), DepthLSSTransform (in 256, out 80,
    118 bins) and the fuser (80 + lidar_channels -> 256, which the decoder's
    first conv then takes)."""
    def r(*shape):
        return (rng.randn(*shape) * 0.05).astype(np.float32)

    sd = {f"encoders.camera.backbone.{k}": v
          for k, v in _torch_style_sd(**SWIN_T, mmdet_names=mmdet_names,
                                      seed=int(rng.randint(1 << 30))).items()}
    if mmdet_names:  # mmdet's own prefix is the slice's here
        sd = {k.replace("backbone.backbone.", "backbone."): v for k, v in sd.items()}

    def bn(name, c):
        sd[f"{name}.weight"] = 1 + r(c)
        sd[f"{name}.bias"] = r(c)
        sd[f"{name}.running_mean"] = r(c)
        sd[f"{name}.running_var"] = 1 + np.abs(r(c))

    nk = "encoders.camera.neck"
    for lvl, cin in ((0, 192 + 256), (1, 384 + 768)):
        sd[f"{nk}.lateral_convs.{lvl}.conv.weight"] = r(256, cin, 1, 1)
        bn(f"{nk}.lateral_convs.{lvl}.bn", 256)
        sd[f"{nk}.fpn_convs.{lvl}.conv.weight"] = r(256, 256, 3, 3)
        bn(f"{nk}.fpn_convs.{lvl}.bn", 256)
    vt = "encoders.camera.vtransform"
    for t, (ci, co, k) in zip((0, 3, 6), ((1, 8, 1), (8, 32, 5), (32, 64, 5))):
        sd[f"{vt}.dtransform.{t}.weight"] = r(co, ci, k, k)
        sd[f"{vt}.dtransform.{t}.bias"] = r(co)
        bn(f"{vt}.dtransform.{t + 1}", co)
    for t, ci in zip((0, 3), (256 + 64, 256)):
        sd[f"{vt}.depthnet.{t}.weight"] = r(256, ci, 3, 3)
        sd[f"{vt}.depthnet.{t}.bias"] = r(256)
        bn(f"{vt}.depthnet.{t + 1}", 256)
    sd[f"{vt}.depthnet.6.weight"] = r(118 + 80, 256, 1, 1)
    sd[f"{vt}.depthnet.6.bias"] = r(118 + 80)
    for t in (0, 3, 6):
        sd[f"{vt}.downsample.{t}.weight"] = r(80, 80, 3, 3)
        bn(f"{vt}.downsample.{t + 1}", 80)
    sd["fuser.0.weight"] = r(256, 80 + lidar_channels, 3, 3)
    bn("fuser.1", 256)
    return sd


@pytest.fixture(scope="module")
def camera_model():
    return build_bevfusion(_cfg(with_camera=True, image_size=(32, 48)), device="cpu").model


@pytest.mark.parametrize("mmdet_names", [False, True])
def test_camera_keys_bit_equal_to_the_jax_route(camera_model, mmdet_names, tmp_path):
    model = camera_model
    lidar_c = model.fuser.fuse.conv.weight.shape[1] - 80
    rng = np.random.RandomState(7)
    ref = dict(_rnd_sd(rng), **_camera_reference(rng, lidar_c, mmdet_names))
    first = "decoder.backbone.blocks.0.0.weight"
    ref[first] = (rng.randn(ref[first].shape[0], 256, 3, 3) * 0.05).astype(np.float32)
    got = convert_bevfusion_state_dict(ref, model)
    params, stats = jax_convert_bevfusion(ref, num_heads=HEADS)
    want = bevfusion_flax_to_state_dict({"params": params, "batch_stats": stats}, model)
    assert set(got) == set(want) == set(model.state_dict())
    for k, v in want.items():
        assert torch.equal(got[k], v), k
        assert got[k].shape == model.state_dict()[k].shape, k
    assert any(k.startswith("camera_backbone.layers.2.blocks.5.") for k in got)
    npz = str(tmp_path / "ref.npz")
    save_raw_state_dict_npz(ref, npz)
    apply_torch_init_bevfusion(model, npz)
    for k, v in model.state_dict().items():
        assert torch.equal(v, got[k]), k
