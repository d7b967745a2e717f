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
so there are no host plan keys).

In a world of several ranks (``parallel``, ``torchrun``) the batch is the
global one, ``samples_per_gpu`` x the world unless ``--batch_size`` names
it: each rank loads and predicts its rows, every rank gathers the global
batch's detections (``parallel.mesh.sharded_eval_predict``), and rank 0
writes ``--out`` and evaluates while the others wait.
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
    dropped by token. In a world of several ranks the loader gives the
    rank's rows, ``predict`` the global batch's detections
    (``parallel.mesh.data_parallel_predict``), and the frames' metadata are
    gathered beside them."""
    from ..parallel.dist import all_gather_objects
    from .steps import predict_feed

    detections: Dict[str, dict] = {}
    n_done = 0
    for batch in loader:
        out = predict(predict_feed(batch))
        out = {k: out[k].cpu().numpy() for k in DET_KEYS}
        metadata = [md for part in all_gather_objects(batch["metadata"]) for md in part]
        for i, md in enumerate(metadata):
            token = md.get("token", str(n_done))
            if token in detections:
                continue  # padded repeat at the tail
            detections[token] = {k: out[k][i] for k in DET_KEYS}
            n_done += 1
        if logger is not None and log_every and n_done % log_every < len(metadata):
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
    out: Optional[str] = None,
    log_every: int = 0,
) -> Dict:
    """Predict (the raw detections pickled to ``out`` when given) + both
    metric paths: the in-training val phase and the test CLIs. In a world
    of several ranks every rank predicts its rows, rank 0 writes and
    evaluates and returns the result, and the others return None once it is
    done."""
    from ..parallel.dist import get_dist_info, synchronize

    detections = predict_dataset(predict, loader, logger, log_every)
    result = None
    if get_dist_info()[0] == 0:
        if out:
            with open(out, "wb") as f:
                pickle.dump(detections, f)
            if logger is not None:
                logger.info(f"raw detections -> {out}")
        result = dataset.evaluation(detections, output_dir=output_dir, testset=testset,
                                    device=device)
        if not testset:
            result = _with_kitti_style(result, dataset, detections, device)
    synchronize()
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
    else from ``--checkpoint``, as in JAX's CLI. Under ``torchrun`` each rank
    joins the group (``nccl``, one rank a card; ``gloo`` with ``--cpu``),
    scores its rows of every global batch, and rank 0 writes ``--out``,
    evaluates and returns the result (None on the other ranks)."""
    from ..data import DataLoader
    from ..device import resolve_device
    from ..models.builder import build_detector, eval_test_cfg
    from ..parallel.dist import init_dist
    from ..parallel.mesh import global_batch_size, sharded_eval_predict
    from ..utils.config import Config
    from ..utils.log import get_root_logger
    from . import checkpoint as ckpt

    rank, world = init_dist("gloo" if args.cpu else "nccl")
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
    batch_size = global_batch_size(args.batch_size, cfg, world)
    loader = DataLoader(dataset, batch_size, shuffle=False, drop_last=False, rank=rank,
                        world=world)
    if torch_init:
        from ..models.convert_second import apply_torch_init

        apply_torch_init(bundle.model, torch_init, logger=logger)
        logger.info(f"initialized from converted torch checkpoint {torch_init}")
    else:
        _, meta = ckpt.load_checkpoint(args.checkpoint, bundle.model)
        logger.info(f"loaded checkpoint epoch {meta.get('epoch')}")

    predict = sharded_eval_predict(bundle, logger)
    result = evaluate_dataset(predict, dataset, loader, work_dir, logger=logger,
                              testset=args.testset, device=device, out=args.out,
                              log_every=max(len(dataset) // 10, 1))
    logger.info(f"evaluation: {result}")
    return result
