#!/usr/bin/env python
"""Evaluation CLI of the PyTorch port under the JAX package's
``tools/dist_test.py`` name and flags.

    python -m dal3d_tpu_torch.tools.dist_test CONFIG --checkpoint WORK_DIR [--out dets.pkl]

One card, one process: the body is ``tools/test.py``'s
(``runtime/evaluation.py::run_eval_cli``); frames sharded over several GPUs
wait for ROADMAP A11. It runs on the CUDA card; ``--cpu`` is the only way
onto the CPU. Beyond the JAX CLI's flags it takes ``tools/test.py``'s
``--torch_init`` (then ``--checkpoint`` may be left out).
"""
import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a detector (distributed)")
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
