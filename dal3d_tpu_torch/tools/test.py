#!/usr/bin/env python
"""Evaluation CLI of the PyTorch port (flags of the JAX package's
``tools/test.py``).

    python -m dal3d_tpu_torch.tools.test CONFIG --checkpoint WORK_DIR [--out dets.pkl]

Predicts the config's ``data.val`` set with the checkpoint's weights, writes
the nuScenes submission json to the work dir (and runs the devkit when it is
installed) and logs a kitti-style AP-40 sweep against the infos' gt boxes
(``runtime/evaluation.py::run_eval_cli``, shared with ``tools/dist_test.py``).
It runs on the CUDA card; ``--cpu`` is the only way onto the CPU (every
kernel wrapper then takes its plain PyTorch version). ``--torch_init NPZ``
takes the weights of a det3d checkpoint converted by
``python -m dal3d_tpu_torch.tools.convert_second`` in place of
``--checkpoint`` (and wins over it, as in the JAX CLI).
"""
import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a detector")
    p.add_argument("config")
    p.add_argument("--checkpoint", help="work_dir with checkpoints")
    p.add_argument("--torch_init", help="npz of a converted det3d checkpoint "
                   "(tools/convert_second.py); wins over --checkpoint")
    p.add_argument("--out", help="pkl file to dump raw detections")
    p.add_argument("--work_dir", default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--testset", action="store_true")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (plain kernel versions)")
    return p.parse_args(argv)


def main(argv=None):
    from ..runtime.evaluation import run_eval_cli

    return run_eval_cli(parse_args(argv))


if __name__ == "__main__":
    main()
