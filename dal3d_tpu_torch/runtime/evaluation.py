"""Predict over a dataset, and the metric evaluation (port of
``dal3d_tpu/runtime/evaluation.py``).

Used by the in-training val workflow (``tools/train.py``) and by the test
CLIs (``tools/test.py``, ``tools/dist_test.py``). Detections come back to the
host per batch, keyed by frame token; the metrics are ``dataset.evaluation``
(the nuScenes submission json, and the devkit when it is installed) plus a
kitti-style AP-40 sweep against the infos' gt boxes, which gives synthetic
runs a detection-quality number to check.

Where the port differs from the JAX module: the batches feed the predict
step their host voxels, or their raw points when the config sets
``voxelize_host = False`` (the port builds its sparse plans on the device,
so there are no host plan keys), and the batch size is the config's
``samples_per_gpu`` on one card (multi-GPU is ROADMAP A11).
"""
from __future__ import annotations

import logging
import os
import pickle
from typing import Callable, Dict, Optional

DET_KEYS = ("box3d_lidar", "scores", "label_preds", "det_valid")


def predict_dataset(
    predict: Callable,
    loader,
    logger: Optional[logging.Logger] = None,
    log_every: int = 0,
) -> Dict[str, dict]:
    """Run the predict step over a loader; returns token -> detections (host
    arrays). The padded repeats of a test-mode loader's last batch are
    dropped by token."""
    from .steps import predict_feed

    detections: Dict[str, dict] = {}
    n_done = 0
    for batch in loader:
        out = predict(predict_feed(batch))
        out = {k: out[k].cpu().numpy() for k in DET_KEYS}
        for i, md in enumerate(batch["metadata"]):
            token = md.get("token", str(n_done))
            if token in detections:
                continue  # padded repeat at the tail
            detections[token] = {k: out[k][i] for k in DET_KEYS}
            n_done += 1
        if logger is not None and log_every and n_done % log_every < len(batch["metadata"]):
            logger.info(f"scored {n_done} frames")
    return detections


def kitti_style_eval(dataset, detections: Dict[str, dict], device=None) -> Dict[str, float]:
    """AP-40 BEV / 3D against the dataset infos' gt boxes (tokens aligned);
    the IoUs run on ``device`` (``None``: the CUDA card)."""
    from ..eval.kitti_eval import kitti_eval
    from ..eval.matched_iou import detections_to_frames, infos_to_frames

    labeled = [i for i in dataset.infos if i.get("gt_boxes") is not None]
    if not labeled:
        return {}
    gt_map = infos_to_frames(labeled)
    pred_map = detections_to_frames(detections, list(dataset.class_names))
    tokens = [t for t in gt_map if t in pred_map]
    if not tokens:
        return {}
    gt_frames = [gt_map[t] for t in tokens]
    pred_frames = [pred_map[t] for t in tokens]
    present = {str(n) for g in gt_frames for n in g["names"]}
    classes = [c for c in dataset.class_names if c in present] or list(dataset.class_names)
    return kitti_eval(gt_frames, pred_frames, classes, device=device)["results"]


def _with_kitti_style(result, dataset, detections, device):
    ap = kitti_style_eval(dataset, detections, device=device)
    if ap:
        result = dict(result or {})
        result["kitti_style"] = {
            k: round(float(v), 4) for k, v in ap.items() if k.startswith("mAP")
        }
    return result


def evaluate_dataset(
    predict: Callable,
    dataset,
    loader,
    output_dir: str,
    logger: Optional[logging.Logger] = None,
    testset: bool = False,
    device=None,
) -> Dict:
    """Predict + both metric paths (the in-training val phase)."""
    detections = predict_dataset(predict, loader, logger)
    result = dataset.evaluation(detections, output_dir=output_dir, testset=testset)
    if not testset:
        result = _with_kitti_style(result, dataset, detections, device)
    return result


def build_val_dataset(cfg):
    """The config's ``data.val`` dataset in test mode, fed host voxels (raw
    points under ``voxelize_host = False``)."""
    from ..data import NuScenesDataset
    from ..models.builder import loader_voxelize_cfg

    val = dict(cfg["data"]["val"])
    return NuScenesDataset(
        info_path=val["info_path"],
        root_path=val.get("root_path", ""),
        nsweeps=val.get("nsweeps", 10),
        class_names=val.get("class_names"),
        pipeline=[dict(s) for s in val.get("pipeline", [])],
        tasks=[dict(t) for t in cfg["tasks"]],
        max_points=cfg.get("max_points", 300000),
        voxelize_host=loader_voxelize_cfg(cfg),
        test_mode=True,
    )


def run_eval_cli(args) -> Dict:
    """Shared body of ``tools/test.py`` and ``tools/dist_test.py``. ``args``
    needs: config, checkpoint, torch_init (optional), out, work_dir,
    batch_size, testset, cpu. Runs on the CUDA card (raises without one)
    unless ``args.cpu``. The weights come from ``--torch_init`` (an npz of a
    det3d checkpoint written by ``tools/convert_second.py``) when it is given,
    else from ``--checkpoint``, as in JAX's CLI."""
    from ..data import DataLoader
    from ..device import resolve_device
    from ..models.builder import build_detector, eval_test_cfg
    from ..utils.config import Config
    from ..utils.log import get_root_logger
    from . import checkpoint as ckpt
    from .steps import make_predict_step

    device = resolve_device("cpu" if args.cpu else None)  # raises here without a GPU
    torch_init = getattr(args, "torch_init", None)
    if not (torch_init or args.checkpoint):
        raise SystemExit("one of --checkpoint / --torch_init is required")
    cfg = Config.fromfile(args.config)
    work_dir = args.work_dir or cfg["work_dir"]
    os.makedirs(work_dir, exist_ok=True)
    logger = get_root_logger(os.path.join(work_dir, "test.log"), cfg.get("log_level", "INFO"))

    cfg["test_cfg"] = eval_test_cfg(cfg, logger)
    bundle = build_detector(cfg, device=device)
    dataset = build_val_dataset(cfg)
    batch_size = args.batch_size or cfg["data"].get("samples_per_gpu", 2)
    loader = DataLoader(dataset, batch_size, shuffle=False, drop_last=False)
    if torch_init:
        from ..models.convert_second import apply_torch_init

        apply_torch_init(bundle.model, torch_init, logger=logger)
        logger.info(f"initialized from converted torch checkpoint {torch_init}")
    else:
        _, meta = ckpt.load_checkpoint(args.checkpoint, bundle.model)
        logger.info(f"loaded checkpoint epoch {meta.get('epoch')}")

    detections = predict_dataset(
        make_predict_step(bundle), loader, logger=logger,
        log_every=max(len(dataset) // 10, 1),
    )
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(detections, f)
        logger.info(f"raw detections -> {args.out}")

    result = dataset.evaluation(detections, output_dir=work_dir, testset=args.testset)
    if not args.testset:
        result = _with_kitti_style(result, dataset, detections, device)
    logger.info(f"evaluation: {result}")
    return result
