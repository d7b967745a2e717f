"""The port's BEVFusion training CLI on the CPU (plain versions of the
kernels): ``python -m dal3d_tpu_torch.tools.train_bevfusion`` with --cpu on
configs/bevfusion_synthetic.py pointed at a tiny synthetic set trains an
epoch and writes its checkpoint, --resume_from continues the step count and
the epochs, --budget reads the ``_B`` infos, --load_from copies what matches
into a model of another width (and exits when nothing matches), --swin_init
needs a camera branch, and what is not ported raises with its ROADMAP item.
A stage-2 config (camera + lidar, derived from configs/bevfusion_cl.py at
small widths) trains from a stage-1 work dir (--load_from) with a converted
Swin (--swin_init) on a synthetic camera set."""
import os

import numpy as np
import pytest
import torch

from dal3d_tpu_torch.data.datasets.synthetic import make_synthetic_nuscenes
from dal3d_tpu_torch.models.builder import bevfusion_optimizer, build_bevfusion
from dal3d_tpu_torch.runtime.checkpoint import latest_epoch, load_checkpoint
from dal3d_tpu_torch.tools import train_bevfusion

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The lane runs several workers side by side: a full set of intra-op
    threads in each makes them fight for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synthetic_cli(tmp_path_factory):
    """configs/bevfusion_synthetic.py pointed at a 4-frame synthetic set
    (its three classes over two tasks) and a budget subset of it."""
    from dal3d_tpu_torch.utils.fileio import dump, load

    root = tmp_path_factory.mktemp("bevfusion_cli")
    info = make_synthetic_nuscenes(str(root / "data"), n_frames=4, n_logs=1,
                                   points_per_frame=3000, range_xy=7.0, max_boxes=6, seed=3,
                                   classes=["car", "pedestrian", "traffic_cone"])
    dump(load(info)[:2], info.replace(".pkl", "_2.pkl"))
    src = open(os.path.join(CONFIGS, "bevfusion_synthetic.py")).read()
    src += (f'\ndata["train"]["info_path"] = {info!r}\n'
            f'data["train"]["root_path"] = {str(root / "data")!r}\n'
            'log_config = dict(interval=1)\n')
    cfg = root / "bevfusion_cli.py"
    cfg.write_text(src)
    return root, str(cfg)


def test_cli_epoch_resume_and_budget(synthetic_cli, monkeypatch):
    """An epoch with --cpu writes epoch_1.pth (weights, optimizer, step);
    --resume_from continues the step count and the epochs; --budget trains
    on the _B infos; without --cpu on a box with no GPU it raises;
    --swin_init on a lidar-only config exits."""
    root, cfg = synthetic_cli
    work = str(root / "work")
    r1 = train_bevfusion.main([cfg, "--cpu", "--epochs", "1", "--work_dir", work])
    n1 = r1["optimizer"].count
    assert n1 >= 2 and latest_epoch(work) == 1
    assert all(np.isfinite(v) for v in r1["logs"].values()) and r1["logs"]["num_matched"] > 0
    bundle = build_bevfusion(train_bevfusion.Config.fromfile(cfg), device="cpu")
    opt = bevfusion_optimizer(train_bevfusion.Config.fromfile(cfg), bundle, 10)
    _, meta = load_checkpoint(work, bundle.model, optimizer=opt)
    assert meta == {"epoch": 1, "global_step": n1} and opt.count == n1
    for k, v in r1["bundle"].model.state_dict().items():
        assert torch.equal(bundle.model.state_dict()[k], v), k
    r2 = train_bevfusion.main([cfg, "--cpu", "--epochs", "2", "--work_dir", work,
                               "--resume_from", work])
    assert r2["optimizer"].count == 2 * n1 and latest_epoch(work) == 2
    rb = train_bevfusion.main([cfg, "--cpu", "--epochs", "1", "--work_dir", str(root / "b"),
                               "--budget", "2"])
    assert rb["optimizer"].count == 1
    log = open(root / "b" / "train.log").read()
    assert "AL budget 2: training on" in log and "_2.pkl" in log
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_bevfusion.main([cfg, "--epochs", "1", "--work_dir", str(root / "gpu")])
    with pytest.raises(SystemExit, match="no camera branch"):
        train_bevfusion.main([cfg, "--cpu", "--epochs", "1", "--work_dir", str(root / "s"),
                              "--swin_init", "x.npz"])
    with pytest.raises(NotImplementedError, match="A11"):
        train_bevfusion.main([cfg, "--cpu", "--n_model", "2"])


def test_cli_load_from_another_head_and_nothing_matching(synthetic_cli):
    """--load_from copies the tensors whose name and shape match (here every
    encoder tensor, while the wider decoder keeps its init) and starts a
    fresh optimizer; a checkpoint with nothing in common exits."""
    from dal3d_tpu_torch.runtime.checkpoint import save_checkpoint

    root, cfg = synthetic_cli
    src = str(root / "src")
    n_epoch = train_bevfusion.main([cfg, "--cpu", "--epochs", "1", "--work_dir",
                                    src])["optimizer"].count
    wide = root / "wide.py"
    wide.write_text(open(cfg).read() + '\nmodel["decoder_channels"] = (48, 64)\n')
    r = train_bevfusion.main([str(wide), "--cpu", "--epochs", "1", "--work_dir",
                              str(root / "dst"), "--load_from", src])
    log = open(root / "dst" / "train.log").read()
    copied, kept = (int(x) for x in
                    log.split("partial warm-start from ")[1].split(": ")[1].split(" ")[0:4:3])
    assert copied > 40 and kept > 4
    assert r["optimizer"].count == n_epoch  # a fresh optimizer: one epoch's steps
    other = str(root / "other")
    save_checkpoint(other, torch.nn.Linear(3, 3), 1)
    with pytest.raises(SystemExit, match="no matching tensors"):
        train_bevfusion.main([cfg, "--cpu", "--epochs", "1", "--work_dir", str(root / "x"),
                              "--load_from", other])


def stage2_config(path, data_root: str, info: str, image_hw=(32, 48)) -> str:
    """configs/bevfusion_cl.py on top of configs/bevfusion_synthetic.py (in
    place of its full-width stage-1 base), cut to the synthetic scenes: the
    synthetic classes, proposals and caps, the camera pipeline at
    ``image_hw``, a log line every step."""
    base = open(os.path.join(CONFIGS, "bevfusion_synthetic.py")).read()
    cl = open(os.path.join(CONFIGS, "bevfusion_cl.py")).read()
    cl = cl.replace("from bevfusion_lidar import *  # noqa: F401,F403", base)
    cl += (f"\nmodel.update(num_classes=3, num_proposals=32, voxel_caps=(4000, 2000, 1000, 1000),"
           f" decoder_channels=(32, 64), image_size={tuple(image_hw)!r})\n"
           "for _st in train_pipeline:\n"
           "    if _st['type'] in ('ImageAug3D', 'ReformatCamera'):\n"
           f"        _st['final_dim'] = {tuple(image_hw)!r}\n"
           "    if _st['type'] == 'ImageAug3D':\n"
           "        _st['resize_lim'] = (0.45, 0.55)\n"
           f"data['train'].update(root_path={data_root!r}, info_path={info!r})\n"
           "log_config = dict(interval=1)\n")
    with open(path, "w") as f:
        f.write(cl)
    return str(path)


def test_cli_stage2_from_stage1_with_swin_init(synthetic_cli, tmp_path):
    """Stage 2 on the CPU: a stage-1 epoch, then the camera + lidar config
    (bevfusion_cl.py's model and camera pipeline on synthetic 64 x 96 ring
    frames) with --load_from the stage-1 work dir and --swin_init of a
    seeded torch-named Swin-T through tools/convert_swin.py (the resume of
    a stage-2 run is held on the card, chip_smoke.py phase 19)."""
    from dal3d_tpu_torch.tools import convert_swin
    from test_swin_convert import _torch_style_sd

    root, cfg1 = synthetic_cli
    stage1 = str(tmp_path / "stage1")
    train_bevfusion.main([cfg1, "--cpu", "--epochs", "1", "--work_dir", stage1])
    data = tmp_path / "cam_data"
    info = make_synthetic_nuscenes(str(data), n_frames=4, n_logs=1, points_per_frame=3000,
                                   range_xy=7.0, max_boxes=6, seed=4, with_camera=True,
                                   image_hw=(64, 96),
                                   classes=["car", "pedestrian", "traffic_cone"])
    cfg2 = stage2_config(tmp_path / "stage2.py", str(data), info)
    sd = _torch_style_sd(embed=96, depths=(2, 2, 6, 2), heads=(3, 6, 12, 24), ws=7,
                         out_indices=(1, 2, 3), seed=9)
    pth, npz = str(tmp_path / "swint.pth"), str(tmp_path / "swint.npz")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    convert_swin.main([pth, npz])
    work = str(tmp_path / "stage2")
    r = train_bevfusion.main([cfg2, "--cpu", "--epochs", "1", "--batch_size", "2",
                              "--work_dir", work, "--load_from", stage1, "--swin_init", npz])
    model, n = r["bundle"].model, r["optimizer"].count
    assert model.with_camera and n >= 2 and latest_epoch(work) == 1
    assert all(np.isfinite(v) for v in r["logs"].values()) and r["logs"]["num_matched"] > 0
    log = open(os.path.join(work, "train.log")).read()
    copied, kept = (int(x) for x in
                    log.split("partial warm-start from ")[1].split(": ")[1].split(" ")[0:4:3])
    assert copied > 40 and kept > 100  # the lidar encoder and head; the camera branch is new
    assert "camera backbone initialised from" in log
