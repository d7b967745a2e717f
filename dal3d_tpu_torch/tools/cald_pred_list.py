#!/usr/bin/env python
"""Detections of the (optionally flip-augmented) pool -> ``pred_list-aug.pkl``
(the port of the JAX package's ``tools/cald_pred_list.py``). Run it twice,
plain and with ``--augment``, and feed both lists to ``tools/cald_ent.py``.

    python -m dal3d_tpu_torch.tools.cald_pred_list CONFIG --checkpoint WORK_DIR --augment

The body is ``tools/ppal_pred_list.py``'s (``predict_pool``); only the
default output name differs. It runs on the CUDA card; ``--cpu`` is the only
way onto the CPU.
"""
from .ppal_pred_list import parse_args, predict_pool


def main(argv=None):
    return predict_pool(parse_args(argv, default_out="pred_list-aug.pkl"))


if __name__ == "__main__":
    main()
