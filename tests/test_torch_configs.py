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


@pytest.mark.parametrize("backbone,item", [
    (dict(impl="brick"), "A9.d.3"), (dict(impl="hybrid"), "A9.d.4"),
    (dict(impl="dense"), "A9.d.4"), (dict(impl="gather", dtype="bfloat16"), "A9.d.5")])
def test_engines_not_ported_name_their_item(backbone, item):
    cfg = copy.deepcopy(small_cfg())
    cfg["model"]["backbone"].update(backbone)
    with pytest.raises(NotImplementedError, match=item):
        build_detector(cfg, device="cpu")
    cfg["model"]["backbone"].update(impl="sparse")
    with pytest.raises(ValueError, match="unknown backbone impl"):
        build_detector(cfg, device="cpu")
