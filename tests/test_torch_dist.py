"""The port's process-group helpers (dal3d_tpu_torch/parallel/dist.py and
mesh.py's batch helpers) and the loader's rank rows, on the CPU.

- The single-process passthrough against JAX's ``dal3d_tpu/parallel/dist.py``
  (the same rank, world, gathered objects, master_only call).
- A real ``gloo`` world of 3 (tests/torch_dist_worker.py): the
  ``all_gather_objects`` payloads of tests/test_dist.py (pickles of
  different sizes) on every rank, ``master_only``, ``write_once``,
  ``all_reduce_sum`` and its gradient, ``shared_normaliser``, ``init_dist``
  keeping the group it finds, and ``data_parallel_predict`` gathering rows
  of five dtypes in frame order.
- ``init_dist`` from torchrun's variables with ``WORLD_SIZE=1``: a group of
  one; without ``WORLD_SIZE``: nothing.
- The loader: the ranks' rows in rank order are the one-process global
  batches, in train mode (shuffled, the tail dropped) and in test mode (the
  tail padded before the split); a global batch that does not split is
  refused.
- ``train`` (no ``--seed``) and ``train_bevfusion`` in that world, each rank
  starting numpy's generator from a state of its own: every rank resamples
  rank 0's CBGS train set, which is one process's from that state, and the
  ranks then draw streams of their own.
- The CLIs refuse ``--n_model 2`` naming A11.b, and a ``--batch_size`` that
  does not divide by the world.

Every comparison here is exact.
"""
import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dal3d_tpu.parallel import dist as jax_dist
from dal3d_tpu_torch.data.datasets.synthetic import make_synthetic_nuscenes
from dal3d_tpu_torch.data.loader import DataLoader
from dal3d_tpu_torch.parallel import dist as pd
from dal3d_tpu_torch.parallel.mesh import global_batch_size, shard_batch
from dal3d_tpu_torch.tools import train, train_bevfusion
from test_torch_camera_branch import few_threads  # noqa: F401
from test_torch_trainer import _write_cfg
import torch_dist_worker as w

pytestmark = pytest.mark.usefixtures("few_threads")


CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
TOOLS = ("train", "train_bevfusion")


def _train_configs(tmp: str) -> dict:
    """A CBGS config (tests/test_torch_trainer.py's) and
    configs/bevfusion_synthetic.py, both on one synthetic labeled set of
    every class: {tool: config path}."""
    root = os.path.join(tmp, "nusc")
    info = make_synthetic_nuscenes(root, n_frames=8, n_logs=2, points_per_frame=500,
                                   range_xy=6.0, max_boxes=6, seed=6)
    cbgs = _write_cfg(os.path.join(tmp, "cbgs.py"), info, os.path.join(tmp, "work_cbgs"))
    bev = os.path.join(tmp, "bevfusion.py")
    with open(bev, "w") as f:
        f.write(open(os.path.join(CONFIGS, "bevfusion_synthetic.py")).read()
                + f'\ndata["train"]["info_path"] = {info!r}\n'
                f'data["train"]["root_path"] = {root!r}\n')
    return {"train": cbgs, "train_bevfusion": bev}


@pytest.fixture(scope="module")
def train_cfgs(tmp_path_factory):
    return _train_configs(str(tmp_path_factory.mktemp("train_cfgs")))


@pytest.fixture(scope="module")
def world3(tmp_path_factory, train_cfgs):
    tmp = str(tmp_path_factory.mktemp("world3"))
    handle = w.start_world(3, tmp, [("helpers", "dist_helpers", {"tmp": tmp}),
                                    ("rows", "gathered_rows", {})]
                           + [(f"infos_{t}", "resampled_infos",
                               dict(tool=t, cfg=train_cfgs[t],
                                    work=os.path.join(tmp, f"work_{t}")))
                              for t in TOOLS])
    return w.join_world(handle, timeout=180)


def test_single_process_passthrough_matches_jax():
    assert pd.get_dist_info() == jax_dist.get_dist_info() == (0, 1)
    assert pd.all_gather_objects({"a": 1}) == jax_dist.all_gather_objects({"a": 1})
    pd.synchronize()
    jax_dist.synchronize()
    calls = []
    for mod in (pd, jax_dist):
        @mod.master_only
        def write():
            calls.append(1)
            return "wrote"

        assert write() == "wrote"
    assert calls == [1, 1]
    wrote = []
    pd.write_once(lambda: wrote.append(1))
    x = torch.ones(3)
    assert wrote == [1] and pd.all_reduce_sum(x) is x
    assert float(pd.shared_normaliser(torch.tensor(0.0), 1.0)) == 1.0
    assert int(pd.shared_normaliser(torch.tensor(7))) == 7


def test_world_of_3_info_and_master_only(world3):
    for r, res in enumerate(world3):
        h = w.result(res, "helpers")
        assert h["info"] == (r, 3)
        assert h["wrote"] == ("wrote" if r == 0 else None)
        assert h["calls"] == ([0] if r == 0 else [])


def test_world_of_3_gathers_objects_of_different_sizes(world3):
    """tests/test_dist.py's payloads, gathered for real: every rank holds
    every rank's object, in rank order (JAX's faked 3-process gather)."""
    for res in world3:
        assert w.result(res, "helpers")["gathered"] == w.PAYLOADS


def test_world_of_3_write_once_is_whole_on_every_rank(world3):
    for res in world3:
        assert w.result(res, "helpers")["read"] == '{"ranks": 3}'


def test_world_of_3_all_reduce_sum_and_its_gradient(world3):
    """y = x_0 + x_1 + x_2 on every rank; each rank's loss sum(y * [0, 1, 2])
    gives every x_r the gradient summed over the three losses."""
    for res in world3:
        h = w.result(res, "helpers")
        np.testing.assert_array_equal(h["sum"], np.full(3, 6.0, np.float32))
        np.testing.assert_array_equal(h["grad"], np.array([0.0, 3.0, 6.0], np.float32))


def test_world_of_3_shared_normaliser(world3):
    """clamp(0 + 1 + 2, 1) / 3 on every rank."""
    for res in world3:
        assert w.result(res, "helpers")["normaliser"] == 1.0


def test_world_of_3_init_dist_keeps_the_group(world3):
    for r, res in enumerate(world3):
        assert w.result(res, "helpers")["init_dist"] == (r, 3)


def test_world_of_3_gathered_rows_in_frame_order(world3):
    batch = w.global_rows(3)
    x = batch["x"]
    want = {"f32": x * 2, "i32": x, "i64": x + 1, "bool": (x > 3).astype(np.float32),
            "bf16": torch.from_numpy(x).to(torch.bfloat16).float().numpy(),
            "wide": np.repeat(x[:, :, None], 3, axis=2)}
    for res in world3:
        out = w.result(res, "rows")["out"]
        assert set(out) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(out[k], v, err_msg=k)


@pytest.mark.parametrize("world", [2, 3])
def test_shard_batch_takes_the_rank_rows(world3, world):
    batch = w.global_rows(world)
    parts = [shard_batch(batch, r, world) for r in range(world)]
    np.testing.assert_array_equal(np.concatenate([p["x"] for p in parts]), batch["x"])
    for t in range(2):
        np.testing.assert_array_equal(np.concatenate([p["gt"][t] for p in parts]),
                                      batch["gt"][t])
    assert [m for p in parts for m in p["metadata"]] == batch["metadata"]
    if world == 3:  # the world's own ranks took the same rows
        for r, res in enumerate(world3):
            np.testing.assert_array_equal(w.result(res, "rows")["mine"]["x"], parts[r]["x"])


@pytest.mark.parametrize("tool", TOOLS)
def test_world_of_3_ranks_resample_the_same_frames(world3, train_cfgs, tmp_path, tool):
    """Each rank starts numpy's generator from a state of its own (no
    --seed): every rank's CBGS-resampled train set is rank 0's, which is
    what one process resamples from rank 0's state; after the build the
    ranks draw streams of their own, rank 0 the one process's."""
    got = [w.result(res, f"infos_{tool}") for res in world3]
    one = [w.resampled_infos(r, 1, tool, train_cfgs[tool], str(tmp_path / f"one{r}"))
           for r in (0, 1)]
    assert got[0]["tokens"] and all(g["tokens"] == got[0]["tokens"] for g in got)
    assert got[0] == one[0]
    assert one[1]["tokens"] != one[0]["tokens"]  # rank 1's own state resamples other frames
    assert len({g["next_draw"] for g in got}) == len(got)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_init_dist_from_torchrun_variables_starts_a_group_of_one(monkeypatch):
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                     MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(k, v)
    try:
        assert pd.init_dist("gloo") == (0, 1)
        assert dist.is_initialized() and pd.get_dist_info() == (0, 1)
        assert pd.all_gather_objects("x") == ["x"]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_init_dist_without_world_size_does_nothing(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert pd.init_dist("nccl") == (0, 1)
    assert not dist.is_initialized()


class _Frames:
    """A dataset whose example i is {"i": [i], "metadata": {"token": i}}."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.array([i]), "metadata": {"token": i}}


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_loader_rank_rows_form_the_global_batches(world, mode):
    train_mode = mode == "train"
    n, batch = 11, 2 * world

    def loader(rank=0, world_=1):
        return DataLoader(_Frames(n), batch, shuffle=train_mode, drop_last=train_mode,
                          seed=4, rank=rank, world=world_, prefetch=0)

    one = [b["i"][:, 0].tolist() for b in loader()]
    ranks = [[b["i"][:, 0].tolist() for b in loader(r, world)] for r in range(world)]
    assert all(len(r) == len(one) == len(loader()) for r in ranks)
    for k, global_rows in enumerate(one):
        assert sum((r[k] for r in ranks), []) == global_rows
        assert all(len(r[k]) == 2 for r in ranks)
    if not train_mode:  # the tail padded with the last frame, then split
        assert one[-1][-1] == n - 1 and sorted({i for b in one for i in b}) == list(range(n))


def test_loader_refuses_a_batch_that_does_not_split():
    with pytest.raises(ValueError, match="does not split"):
        DataLoader(_Frames(4), 3, world=2)


def test_global_batch_size_is_samples_per_gpu_times_the_world():
    cfg = {"data": {"samples_per_gpu": 2}}
    assert global_batch_size(None, cfg, 1) == 2
    assert global_batch_size(None, cfg, 3) == 6
    assert global_batch_size(4, cfg, 2) == 4
    with pytest.raises(ValueError, match="--batch_size 3 .* divide by the 2 ranks"):
        global_batch_size(3, cfg, 2)


@pytest.mark.parametrize("tool", [train, train_bevfusion])
def test_n_model_is_refused_naming_a11b(tool):
    with pytest.raises(NotImplementedError, match=r"A11\.b"):
        tool.main(["no_config.py", "--cpu", "--n_model", "2"])
