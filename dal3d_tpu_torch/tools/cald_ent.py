#!/usr/bin/env python
"""CALD consistency and JS-divergence pre-pass (the port of the JAX
package's ``tools/cald_ent.py``).

    python -m dal3d_tpu_torch.tools.cald_ent CONFIG --pred_list pred_list.pkl --pred_list_aug pred_list-aug.pkl

Matches the plain predictions against the flip-augmented ones (the augmented
list plays the reference role, as the reference's ``_cald`` evaluator fork),
ranks the pool by consistency min |scale_iou + 0.5 (1 - js) (p + q) - 1.3|
and takes each frame's class-distribution JS divergence; writes
``cald_ent_sorted_idx.json`` and ``idx_to_jsdiv.pkl``, which ``CaldSelector``
reads. Host numpy (``eval/matched_iou.py``); like every CLI of the port it
asks for the CUDA card unless ``--cpu`` is given.
"""
import argparse
import pickle


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="CALD consistency ranking")
    p.add_argument("config")
    p.add_argument("--pred_list", default="pred_list.pkl", help="original-input predictions")
    p.add_argument("--pred_list_aug", default="pred_list-aug.pkl",
                   help="augmented-input predictions")
    p.add_argument("--sorted_out", default="cald_ent_sorted_idx.json")
    p.add_argument("--jsdiv_out", default="idx_to_jsdiv.pkl")
    p.add_argument("--dist_th", type=float, default=1.0)
    p.add_argument("--cpu", action="store_true", help="run without the CUDA card")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..device import resolve_device

    resolve_device("cpu" if args.cpu else None)  # raises here without a GPU
    from ..eval.matched_iou import (accumulate_matches, cald_consistency,
                                    class_distribution_jsdiv, detections_to_frames)
    from ..utils.config import Config
    from ..utils.fileio import dump, load

    cfg = Config.fromfile(args.config)
    class_names = [n for t in cfg["tasks"] for n in t["class_names"]]
    infos = load(dict(cfg["selector"])["infos_origin"])
    all_tokens = [i["token"] for i in infos]

    with open(args.pred_list, "rb") as f:
        pred = pickle.load(f)
    with open(args.pred_list_aug, "rb") as f:
        pred_aug = pickle.load(f)
    frames = detections_to_frames(pred, class_names)
    frames_aug = detections_to_frames(pred_aug, class_names)
    # augmented predictions play the reference role
    dict_p_iou = accumulate_matches(frames_aug, frames, class_names, args.dist_th)

    _, order = cald_consistency(dict_p_iou, all_tokens)
    dump(order, args.sorted_out)
    jsdiv = class_distribution_jsdiv(dict_p_iou, all_tokens, class_names)
    with open(args.jsdiv_out, "wb") as f:
        pickle.dump(jsdiv, f)
    print(f"consistency ranking -> {args.sorted_out}; jsdiv -> {args.jsdiv_out}")
    return order, jsdiv


if __name__ == "__main__":
    main()
