"""``create_data synthetic_data_prep --with_camera`` through both CLIs: the
port's (``dal3d_tpu_torch/tools/create_data.py``) and JAX's
(``tools/create_data.py``), each from its own working directory with the
same relative root, on a few frames. The infos, the log file and every
lidar and camera file are byte-equal. The GT database is compared by
content: the two packages build it with different sweep counts (JAX's CLI
1, the port's 10, the count its configs read), so each object's point file
of the port starts with JAX's key-frame points, bit for bit, and goes on
with its sweeps' points (time lag > 0); the records agree but for the
path's name and the point count."""
import filecmp
import importlib.util
import os
import pickle
import sys

import numpy as np
import pytest

from dal3d_tpu_torch.tools import create_data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["synthetic_data_prep", "--root_path", "data/synthetic", "--n_frames", "4",
        "--n_logs", "2", "--range_xy", "7", "--with_camera"]


def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_create_data",
                                                  os.path.join(ROOT, "tools", "create_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_parser_takes_with_camera():
    args = create_data.parse_args(["synthetic_data_prep", "--root_path", "d", "--with_camera"])
    assert args.with_camera
    assert not create_data.parse_args(["synthetic_data_prep", "--root_path", "d"]).with_camera


def test_with_camera_matches_jax_cli(tmp_path, monkeypatch):
    roots = {}
    for tag in ("jax", "port"):
        ws = tmp_path / tag
        ws.mkdir()
        monkeypatch.chdir(ws)
        if tag == "jax":
            monkeypatch.setattr(sys, "argv", ["create_data.py", *ARGS])
            _jax_cli().main()
        else:
            create_data.main(ARGS)
        roots[tag] = str(ws / "data" / "synthetic")
    jr, pr = roots["jax"], roots["port"]
    jdb, pdb = "gt_database_1sweeps_withvelo", "gt_database_10sweeps_withvelo"
    jinfo, pinfo = "dbinfos_train_1sweeps_withvelo.pkl", "dbinfos_train_10sweeps_withvelo.pkl"

    def plain(files, db, info):
        return [f for f in files if not f.startswith(db + os.sep) and f != info]

    jf, pf = _files(jr), _files(pr)
    assert plain(jf, jdb, jinfo) == plain(pf, pdb, pinfo)
    # six images a frame; the val split's tokens start at 0 again, so its two
    # frames write over the train split's first two, in both packages
    cams = [f for f in pf if f.startswith(os.path.join("samples", "CAM_"))]
    assert len(cams) == 6 * 4 and all(f.endswith(".jpg") for f in cams)
    for f in plain(pf, pdb, pinfo):
        assert filecmp.cmp(os.path.join(jr, f), os.path.join(pr, f), shallow=False), f
    infos = pickle.load(open(os.path.join(pr, "infos_train_10sweeps_withvelo.pkl"), "rb"))
    assert all(len(i["cams"]) == 6 for i in infos)

    # the GT database: the same objects, point files and records under either name
    jdbf = sorted(os.path.relpath(f, jdb) for f in jf if f.startswith(jdb + os.sep))
    pdbf = sorted(os.path.relpath(f, pdb) for f in pf if f.startswith(pdb + os.sep))
    assert jdbf == pdbf and jdbf
    counts = {}
    for f in pdbf:
        a = np.fromfile(os.path.join(jr, jdb, f), np.float32).reshape(-1, 5)
        b = np.fromfile(os.path.join(pr, pdb, f), np.float32).reshape(-1, 5)
        np.testing.assert_array_equal(b[:len(a)], a)
        assert (a[:, 4] == 0).all() and (b[len(a):, 4] > 0).all(), f
        counts[f] = (len(a), len(b))
    assert sum(n for _, n in counts.values()) > sum(n for n, _ in counts.values()) > 0
    ji = pickle.load(open(os.path.join(jr, jinfo), "rb"))
    pi = pickle.load(open(os.path.join(pr, pinfo), "rb"))
    assert sorted(ji) == sorted(pi)
    for cls in ji:
        assert len(ji[cls]) == len(pi[cls])
        for a, b in zip(ji[cls], pi[cls]):
            assert sorted(a) == sorted(b)
            for k in a:
                if k == "path":
                    assert a[k].replace(jdb, pdb) == b[k]
                elif k == "num_points_in_gt":
                    assert (a[k], b[k]) == counts[os.path.basename(b["path"])]
                elif isinstance(a[k], np.ndarray):
                    np.testing.assert_array_equal(a[k], b[k])
                else:
                    assert a[k] == b[k], (cls, k)


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
