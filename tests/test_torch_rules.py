"""Rules of the PyTorch port.

- Nothing under dal3d_tpu_torch/, nor chip_smoke.py, imports jax, flax,
  optax or the JAX package.
- An entry point called with no device needs a GPU: on a box without one it
  raises instead of running on the CPU.
- Every kernel wrapper exposes a launch counter, and on CPU tensors it runs
  its plain version (and counts nothing); any other device raises."""
import ast
import os

import numpy as np
import pytest
import torch

from dal3d_tpu_torch.models.builder import build_bevfusion, build_detector
from dal3d_tpu_torch.ops import banded as tbd
from dal3d_tpu_torch.ops import distance as tdist
from dal3d_tpu_torch.ops import gather as tg
from dal3d_tpu_torch.ops import iou_matrix as tiou
from dal3d_tpu_torch.selectors import BaseSelector
from dal3d_tpu_torch.selectors.maps import feature_map
from dal3d_tpu_torch.tools import active_select
from dal3d_tpu_torch.utils.fileio import dump
from torch_port_utils import mk_rulebook, small_cfg, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dal3d_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "dal3d_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_nothing_of_jax():
    files = _port_files()
    assert len(files) > 40
    assert any(f.endswith(os.path.join("tools", "active_select.py")) for f in files)
    assert any(f.endswith(os.path.join("tools", "train.py")) for f in files)
    bad = [(os.path.relpath(f, ROOT), m) for f in files for m in _imported_roots(f)
           if m in FORBIDDEN]
    assert not bad, bad


def test_scan_catches_a_forbidden_import(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text("import os\nfrom dal3d_tpu.ops import banded\n")
    assert "dal3d_tpu" in set(_imported_roots(str(p)))


def test_entry_point_without_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_detector(small_cfg())
    assert build_detector(small_cfg(), device="cpu").device.type == "cpu"
    bev = {"model": dict(type="BEVFusion", num_proposals=4, decoder_channels=(8, 8),
                         decoder_layer_nums=(1, 1), neck_out_channels=(8, 8),
                         hidden_channel=8, ffn_channel=8, num_heads=2),
           "voxel_generator": dict(range=[-3.2, -3.2, -5.0, 3.2, 3.2, 3.0],
                                   voxel_size=[0.2, 0.2, 0.2], max_points_in_voxel=10,
                                   max_voxel_num=100)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_bevfusion(bev)
    assert build_bevfusion(bev, device="cpu").device.type == "cpu"


def test_kernel_wrappers_count_and_take_plain_on_cpu():
    rng = np.random.RandomState(0)
    idx, hit = mk_rulebook(rng, 2, 3, 64, 64, spread=8)
    idx = t(np.where(hit, idx, -1))
    table = t(rng.randn(2, 64, 16).astype(np.float32))
    w = t(rng.randn(3, 16, 24).astype(np.float32))
    rows = tiou._pack_rowdat(t(rng.uniform(1, 4, (2, 10, 5)).astype(np.float32)))
    n1, n2 = tbd.banded_conv.launches, tiou.iou_matrix.launches
    assert isinstance(n1, int) and isinstance(n2, int)
    assert torch.equal(tbd.banded_conv(table, idx, w), tbd.banded_conv_plain(table, idx, w))
    assert torch.equal(tiou.iou_matrix(rows, rows), tiou.iou_matrix_plain(rows, rows))
    assert (tbd.banded_conv.launches, tiou.iou_matrix.launches) == (n1, n2)


def test_kernel_wrappers_refuse_other_devices():
    meta = torch.zeros(2, 8, 8, device="meta")
    with pytest.raises(ValueError):
        tbd.banded_conv(meta, torch.zeros(2, 1, 8, dtype=torch.int32, device="meta"),
                        torch.zeros(1, 8, 8, device="meta"))
    with pytest.raises(ValueError):
        tiou.iou_matrix(torch.zeros(1, 4, 32, device="meta"), torch.zeros(1, 4, 32, device="meta"))


def test_distance_wrappers_count_and_take_plain_on_cpu():
    rng = np.random.RandomState(1)
    x, y = t(rng.rand(5, 16).astype(np.float32)), t(rng.rand(7, 16).astype(np.float32))
    n1, n2 = tdist.pairwise_l1.launches, tdist.pairwise_l2.launches
    assert isinstance(n1, int) and isinstance(n2, int)
    assert torch.equal(tdist.pairwise_l1(x, y), tdist.pairwise_l1_plain(x, y))
    assert torch.equal(tdist.pairwise_l2(x, y), tdist.pairwise_l2_plain(x, y))
    assert torch.equal(tdist.pairwise_l2(x, y, squared=True),
                       tdist.pairwise_l2_plain(x, y, squared=True))
    assert (tdist.pairwise_l1.launches, tdist.pairwise_l2.launches) == (n1, n2)


@pytest.mark.parametrize("fn", [tdist.pairwise_l1, tdist.pairwise_l2])
def test_distance_wrappers_refuse_other_devices(fn):
    with pytest.raises(ValueError):
        fn(torch.zeros(4, 8, device="meta"), torch.zeros(3, 8, device="meta"))


def test_selection_entry_points_without_device_need_a_gpu(monkeypatch, tmp_path):
    """BaseSelector(device=None), feature_map(device=None) and the CLI
    without --cpu raise on a box without a GPU, before doing any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buffer_file, infos = str(tmp_path / "buffer.json"), str(tmp_path / "infos.pkl")
    dump({"0": []}, buffer_file)
    dump([{"gt_names": []}] * 3, infos)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BaseSelector(budget=1, buffer_file=buffer_file, infos_origin=infos)
    assert BaseSelector(budget=1, buffer_file=buffer_file, infos_origin=infos,
                        device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        feature_map(np.zeros((3, 4), np.float32))
    cfg = tmp_path / "cfg.py"
    cfg.write_text(f"selector = dict(type='RandomSelector', budget=1, "
                   f"buffer_file={str(tmp_path / 'missing.json')!r}, infos_origin={infos!r})\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        active_select.main([str(cfg)])
    assert not os.path.exists(tmp_path / "missing.json")
    active_select.main([str(cfg), "--cpu"])  # first round: writes the empty buffer
    assert os.path.exists(tmp_path / "missing.json")


def test_weight_gradient_wrapper_counts_and_takes_plain_on_cpu():
    rng = np.random.RandomState(2)
    idx, hit = mk_rulebook(rng, 2, 3, 64, 64, spread=8)
    idx = t(np.where(hit, idx, -1))
    table = t(rng.randn(2, 64, 16).astype(np.float32))
    g = t(rng.randn(2, 64, 24).astype(np.float32))
    n = tbd.banded_dw.launches
    assert isinstance(n, int)
    assert torch.equal(tbd.banded_dw(table, idx, g), tbd.banded_dw_plain(table, idx, g))
    assert tbd.banded_dw.launches == n
    with pytest.raises(ValueError):
        tbd.banded_dw(torch.zeros(2, 8, 8, device="meta"),
                      torch.zeros(2, 1, 8, dtype=torch.int32, device="meta"),
                      torch.zeros(2, 8, 8, device="meta"))


def test_gather_wrappers_count_and_take_plain_on_cpu():
    rng = np.random.RandomState(3)
    feats = t(rng.randn(2, 50, 8).astype(np.float32))
    idx = t(rng.randint(0, 50, (2, 3, 70)).astype(np.int32))
    hit = t(rng.rand(2, 3, 70) < 0.6)
    w = t(rng.randn(3, 8, 16).astype(np.float32))
    n4, n5 = tg.gather_gemm.launches, tg.gather_rows.launches
    assert isinstance(n4, int) and isinstance(n5, int)
    assert torch.equal(tg.gather_gemm(feats, idx, hit, w),
                       tg.gather_gemm_plain(feats, idx, hit, w))
    assert torch.equal(tg.gather_rows(feats[0], idx[0, 0]), feats[0][idx[0, 0].long()])
    assert (tg.gather_gemm.launches, tg.gather_rows.launches) == (n4, n5)


def test_gather_wrappers_refuse_other_devices():
    with pytest.raises(ValueError):
        tg.gather_gemm(torch.zeros(1, 4, 8, device="meta"),
                       torch.zeros(1, 2, 3, dtype=torch.int32, device="meta"),
                       torch.zeros(1, 2, 3, dtype=torch.bool, device="meta"),
                       torch.zeros(2, 8, 16, device="meta"))
    with pytest.raises(ValueError):
        tg.gather_rows(torch.zeros(4, 8, device="meta"),
                       torch.zeros(3, dtype=torch.int32, device="meta"))
