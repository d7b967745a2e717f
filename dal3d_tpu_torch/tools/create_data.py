#!/usr/bin/env python
"""Data preparation CLI of the PyTorch port (flow and arguments of the JAX
package's ``tools/create_data.py``; host numpy, no device).

    python -m dal3d_tpu_torch.tools.create_data synthetic_data_prep --root_path DIR
    python -m dal3d_tpu_torch.tools.create_data nuscenes_data_prep --root_path DIR [--suffix B]

- ``synthetic_data_prep``: the synthetic nuScenes-schema dataset (train and
  val infos, lidar files, ``v1.0-trainval/log.json`` for the spatial
  selectors) and the GT database of the train infos. The database carries
  the infos' 10-sweep names (``dbinfos_train_10sweeps_withvelo.pkl``), so
  that ``nuscenes_data_prep --suffix`` and the configs' ``db_info_path``
  name the same files.
- ``nuscenes_data_prep``: the GT database of
  ``infos_train_<n>sweeps_withvelo[_<suffix>].pkl``; with ``--suffix`` (the
  AL cumulative budget) it is rebuilt from the selected infos subset, so that
  GT-AUG pastes only labeled objects. Building the info pkls from the raw
  dataset needs the nuScenes devkit and is not ported: without the infos it
  raises before writing anything.
"""
import argparse
import os

from ..data.create_gt_database import create_groundtruth_database
from ..utils.fileio import dump, load


def nuscenes_data_prep(root_path, version="v1.0-trainval", nsweeps=10, suffix=None,
                       infos_only=False):
    info_name = f"infos_train_{nsweeps}sweeps_withvelo" + (f"_{suffix}" if suffix else "")
    info_path = os.path.join(root_path, info_name + ".pkl")
    if not os.path.exists(info_path):
        if suffix is not None:
            raise FileNotFoundError(f"{info_path}: the selection CLI writes the subset infos "
                                    f"of budget {suffix}")
        raise NotImplementedError(
            f"{info_path} is missing: building the infos from the raw nuScenes {version} "
            "needs the devkit (data/nusc_common.py::create_nuscenes_infos), which is not "
            "ported yet (ROADMAP A8.h)")
    if infos_only:
        return None
    return create_groundtruth_database(root_path, info_path, nsweeps=nsweeps, suffix=suffix)


def synthetic_data_prep(root_path, n_frames=32, n_logs=4, seed=0, range_xy=45.0):
    from ..data.datasets.synthetic import make_synthetic_nuscenes

    train = make_synthetic_nuscenes(root_path, n_frames, n_logs, seed=seed, split="train",
                                    range_xy=range_xy)
    make_synthetic_nuscenes(root_path, max(n_frames // 4, 2), n_logs, seed=seed + 1,
                            split="val", range_xy=range_xy)
    # a minimal log.json for the spatial selectors
    infos = load(train)
    logfiles = sorted({i["cam_front_path"].split("/")[-1].split("__")[0] for i in infos})
    dump([{"logfile": lf, "location": "singapore-onenorth"} for lf in logfiles],
         os.path.join(root_path, "v1.0-trainval", "log.json"))
    create_groundtruth_database(root_path, train, nsweeps=10)
    print(f"synthetic dataset at {root_path}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Data preparation")
    sub = p.add_subparsers(dest="cmd", required=True)
    n = sub.add_parser("nuscenes_data_prep")
    n.add_argument("--root_path", required=True)
    n.add_argument("--version", default="v1.0-trainval")
    n.add_argument("--nsweeps", type=int, default=10)
    n.add_argument("--suffix", default=None, help="AL cumulative budget")
    n.add_argument("--infos_only", action="store_true")
    s = sub.add_parser("synthetic_data_prep")
    s.add_argument("--root_path", required=True)
    s.add_argument("--n_frames", type=int, default=32)
    s.add_argument("--n_logs", type=int, default=4)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--range_xy", type=float, default=45.0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.cmd == "nuscenes_data_prep":
        nuscenes_data_prep(args.root_path, args.version, args.nsweeps, args.suffix,
                           args.infos_only)
    else:
        synthetic_data_prep(args.root_path, args.n_frames, args.n_logs, args.seed,
                            args.range_xy)


if __name__ == "__main__":
    main()
