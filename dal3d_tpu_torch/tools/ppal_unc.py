#!/usr/bin/env python
"""PPAL difficulty-weight pre-pass (the port of the JAX package's
``tools/ppal_unc.py``).

    python -m dal3d_tpu_torch.tools.ppal_unc CONFIG --pred_list pred_list.pkl [--out diff_category_average.json]

Matches the pool's detections (``pred_list.pkl`` of ``tools/ppal_pred_list.py``)
to the infos' gt boxes over the labeled subset (the buffer's last round),
takes each match's quality score^0.6 * scale_iou^0.4, and writes the
per-class difficulty weights json that ``PPALSelector`` reads (a class without
a match gets the largest weight), and ``dict_p_iou.pkl`` (the matches) in
the working directory, as the JAX CLI does. Host numpy
(``eval/matched_iou.py``); like every CLI of the port it asks for the CUDA
card unless ``--cpu`` is given.
"""
import argparse
import pickle

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="PPAL difficulty weights")
    p.add_argument("config")
    p.add_argument("--pred_list", default="pred_list.pkl")
    p.add_argument("--out", default="diff_category_average.json")
    p.add_argument("--dist_th", type=float, default=1.0)
    p.add_argument("--cpu", action="store_true", help="run without the CUDA card")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..device import resolve_device

    resolve_device("cpu" if args.cpu else None)  # raises here without a GPU
    from ..eval.matched_iou import (accumulate_matches, detections_to_frames,
                                    infos_to_frames, ppal_difficulty_weights)
    from ..utils.config import Config
    from ..utils.fileio import dump, load

    cfg = Config.fromfile(args.config)
    class_names = [n for t in cfg["tasks"] for n in t["class_names"]]
    sel = dict(cfg["selector"])
    infos = load(sel["infos_origin"])
    buffer = load(sel["buffer_file"])
    labeled = buffer[str(max(int(k) for k in buffer))]
    tokens_subset = [infos[i]["token"] for i in labeled]

    with open(args.pred_list, "rb") as f:
        detections = pickle.load(f)
    pred_frames = detections_to_frames(detections, class_names)
    ref_frames = infos_to_frames(infos)
    dict_p_iou = accumulate_matches(ref_frames, pred_frames, class_names, args.dist_th)

    weights = ppal_difficulty_weights(dict_p_iou, tokens_subset)
    # classes with no matches get the maximum difficulty
    default_w = 1 + 3.0 * np.log((np.exp(1 / 3.0) - 1) * 1.0 + 1) * 2.0
    for c in class_names:
        weights.setdefault(c, float(default_w))
    dump(weights, args.out)
    with open("dict_p_iou.pkl", "wb") as f:
        pickle.dump(dict_p_iou, f)
    print(f"difficulty weights -> {args.out}: {weights}")
    return weights


if __name__ == "__main__":
    main()
