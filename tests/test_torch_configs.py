"""Every config in ``configs/`` that names a model builds through the port as
written, on the CPU: ``build_bevfusion`` for a BEVFusion, ``build_detector``
for the CBGS VoxelNets (the gather engine where a config names none, as in
JAX; the banded one where it asks for it). No forward runs: the full sizes
are for the card. Together with the CLI tests of the synthetic configs
(tests/test_torch_cbgs_gather_cli.py, test_torch_bevfusion_seg_cli.py) this
is the claim that every config runs as written. The backbone engines and
dtypes the port does not run yet are refused with their ROADMAP item."""
import copy
import glob
import os

import pytest
import torch

from dal3d_tpu_torch.models.builder import build_bevfusion, build_detector
from dal3d_tpu_torch.utils.config import Config
from test_torch_camera_branch import few_threads  # noqa: F401
from torch_port_utils import small_cfg

pytestmark = pytest.mark.usefixtures("few_threads")

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
FILES = sorted(os.path.basename(p) for p in glob.glob(os.path.join(CONFIGS, "*.py")))


def test_every_config_is_listed():
    assert len(FILES) == 23 and "bevfusion_cl_synthetic.py" in FILES


@pytest.mark.parametrize("name", FILES)
def test_config_builds_as_written(name):
    cfg = Config.fromfile(os.path.join(CONFIGS, name))
    mc = dict(cfg["model"])
    if mc["type"] == "BEVFusion":
        bundle = build_bevfusion(cfg, device="cpu")
        m = bundle.model
        assert m.head_type == mc.get("head", "transfusion")
        assert (m.seg_head is not None) == bool(mc.get("with_map_seg", False))
        assert m.with_camera == bool(mc.get("with_camera", False))
        return
    bundle = build_detector(cfg, device="cpu")
    bb = dict(mc.get("backbone", {}))
    assert bundle.model.backbone.impl == bb.get("impl", "gather")
    if "voxel_caps" in bb and bundle.model.backbone.impl == "gather":
        assert bundle.model.backbone.caps == tuple(bb["voxel_caps"])


@pytest.mark.parametrize("impl", ["brick", "hybrid", "dense"])
def test_every_engine_builds(impl):
    """configs/cbgs_synthetic.py with another engine builds it, with the
    knobs JAX's builder reads for it (brick: dtype, widths, brick_caps;
    hybrid / dense: voxel_caps), and one state dict loads into each."""
    cfg = Config.fromfile(os.path.join(CONFIGS, "cbgs_synthetic.py"))
    bb = dict(cfg["model"]["backbone"], impl=impl)
    if impl == "brick":
        bb.update(dtype="bfloat16", brick_caps=(900, 1200, 600, 200, 100))
    cfg["model"] = dict(cfg["model"], backbone=bb)
    model = build_detector(cfg, device="cpu").model
    assert model.backbone.impl == impl
    if impl == "brick":
        assert model.backbone.caps == (900, 1200, 600, 200, 100)
        assert model.backbone.l0.stem.dtype == torch.bfloat16
        assert model.backbone.widths == (16, 16, 8, 4, 4) and not model.backbone.spatial
    else:
        assert model.backbone.caps == (8000, 4000, 2000, 2000)
    gather = build_detector(Config.fromfile(os.path.join(CONFIGS, "cbgs_synthetic.py")),
                            device="cpu", seed=1).model
    model.load_state_dict(gather.state_dict(), strict=True)


@pytest.mark.parametrize("backbone,item", [
    (dict(impl="gather", dtype="bfloat16"), "A9.d.5"),
    (dict(impl="hybrid", dtype="bfloat16"), "A9.d.5")])
def test_engines_not_ported_name_their_item(backbone, item):
    cfg = copy.deepcopy(small_cfg())
    cfg["model"]["backbone"].update(backbone)
    with pytest.raises(NotImplementedError, match=item):
        build_detector(cfg, device="cpu")
    cfg["model"]["backbone"].update(impl="sparse")
    with pytest.raises(ValueError, match="unknown backbone impl"):
        build_detector(cfg, device="cpu")
