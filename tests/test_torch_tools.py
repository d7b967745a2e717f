"""The predict FPS harness, ``get_flops`` and the FLOP counter of the PyTorch
port on the CPU, held against the JAX package:

- the parameter count of every distinct model in ``configs/`` (BEVFusion
  lidar-only, as JAX's get_flops builds it) equals the size of JAX's
  ``variables["params"]`` from ``jax.eval_shape``;
- every sparse conv's hits, on the gather, banded and dense engines, equal
  the hits of JAX's ``ops/sparse.py`` rulebooks on the same small voxels;
- the dense FLOPs are 2 x the multiply-adds of the RPN's and the head's
  shapes; XLA's ``cost_analysis()`` of JAX's RPN and head lies within 1 %
  above the FLOPs of the taps that fall inside the input (XLA skips the
  padded taps, which cuDNN computes and the port counts, and adds the
  norms' and activations' elementwise work);
- ``benchmark --cpu`` and ``get_flops --cpu`` run at a tiny size, the
  harness's clouds are JAX's recipe, and a BEVFusion config is refused by
  the harness."""
import copy
import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu_torch.models.builder import build_detector
from dal3d_tpu_torch.tools import benchmark, get_flops
from dal3d_tpu_torch.utils.config import Config as TConfig
from dal3d_tpu_torch.utils.flops import count_forward_flops
from test_torch_camera_branch import few_threads  # noqa: F401
from torch_port_utils import small_cfg, small_gather_cfg, small_voxels, t

pytestmark = pytest.mark.usefixtures("few_threads")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.py")))


def _model_key(path):
    """What fixes the parameter set that JAX's get_flops counts: the CBGS
    model section with its tasks and grid, or BEVFusion's lidar-only
    fields."""
    cfg = TConfig.fromfile(path)
    mc = dict(cfg["model"])
    if get_flops.is_bevfusion(cfg):
        return repr(("bevfusion", dict(cfg["voxel_generator"]), mc.get("num_proposals"),
                     mc.get("voxel_caps"), mc.get("decoder_channels")))
    return repr((mc, [dict(t) for t in cfg["tasks"]], dict(cfg["voxel_generator"])))


def _distinct_models():
    seen = {}
    for p in CONFIGS:
        seen.setdefault(_model_key(p), os.path.basename(p))
    return sorted(seen.values())


def test_distinct_models():
    """23 configs, 5 models: the production CBGS (_cbgs_base.py and the 14
    selector configs on it), cbgs_full.py, the synthetic CBGS, and the two
    BEVFusion widths (the camera configs counted lidar-only)."""
    assert len(CONFIGS) == 23
    assert _distinct_models() == ["_cbgs_base.py", "bevfusion_cl.py",
                                  "bevfusion_cl_synthetic.py", "cbgs_entropy_synthetic.py",
                                  "cbgs_full.py"]


def _jax_param_count(path) -> int:
    from dal3d_tpu.models.bevfusion import BEVFusion
    from dal3d_tpu.models.builder import build_detector as jbuild
    from dal3d_tpu.ops.voxelize import VoxelConfig
    from dal3d_tpu.utils import Config

    cfg = Config.fromfile(path)
    pts = jax.ShapeDtypeStruct((1, 1000, 5), jnp.float32)
    pv = jax.ShapeDtypeStruct((1, 1000), jnp.bool_)
    if "BEVFusion" in str(cfg.model.get("type", "")):  # tools/get_flops.py:27-47
        vg, mc = cfg.voxel_generator, dict(cfg.model)
        model = BEVFusion(
            voxel_cfg=VoxelConfig(tuple(vg["range"]), tuple(vg["voxel_size"]),
                                  int(vg["max_points_in_voxel"]), int(vg["max_voxel_num"])),
            with_camera=False, num_proposals=int(mc.get("num_proposals", 200)),
            voxel_caps=tuple(mc.get("voxel_caps", (120000, 60000, 30000, 30000))),
            decoder_channels=tuple(mc.get("decoder_channels", (128, 256))))
        var = jax.eval_shape(lambda p, q: model.init(
            jax.random.PRNGKey(0), {"points": p, "points_valid": q}, False), pts, pv)
    else:
        model = jbuild(cfg).model
        var = jax.eval_shape(lambda p, q: model.init(jax.random.PRNGKey(0), p, q, False),
                             pts, pv)
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(var["params"]))


@pytest.mark.parametrize("name", _distinct_models())
def test_parameter_count_equals_jax(name):
    path = os.path.join(ROOT, "configs", name)
    model = get_flops.flops_model(TConfig.fromfile(path), torch.device("cpu"))
    n_buffers = sum(b.numel() for b in model.buffers())
    assert n_buffers > 0  # the norms' statistics: not parameters, as in JAX
    assert sum(p.numel() for p in model.parameters()) == _jax_param_count(path)


@functools.lru_cache(maxsize=None)
def _jax_hits(seed, shape, caps):
    """Hits of every sparse conv of the CBGS backbone from JAX's
    ``ops/sparse.py`` rulebooks, in the port's call order: L0's 5 subm
    convs and its downsample, then each stage's 4 subm convs and its
    downsample (one jit: eager JAX compiles op by op; the banded and dense
    cases share it)."""
    from dal3d_tpu.ops import sparse as jsp

    downs = [((3, 3, 3), (2, 2, 2), (1, 1, 1)), ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
             ((3, 3, 3), (2, 2, 2), (0, 1, 1)), ((3, 1, 1), (2, 1, 1), (0, 0, 0))]

    def hits(f, c, v):
        sb = jsp.from_voxels(f, c, v, shape)
        out = []
        for level, (k, s, p) in enumerate(downs):
            out += [jsp.subm_rulebook(sb, 3)[1].sum()] * (5 if level == 0 else 4)
            out_lin, _, hit, out_shape = jsp.downsample_plan(sb, k, s, p, caps[level])
            out.append(hit.sum())
            sb = jsp.SparseBatch(features=jnp.zeros(out_lin.shape + (1,)), lin=out_lin,
                                 shape=out_shape)
        return out

    vf, vc, vv = small_voxels(seed)
    return [int(h) for h in jax.jit(hits)(jnp.asarray(vf), jnp.asarray(vc), jnp.asarray(vv))]


@pytest.mark.parametrize("engine", ["gather", "banded", "dense"])
def test_sparse_hits_equal_jax_rulebooks(engine):
    """The gather engine at caps that bind after each of the first three
    downsamples (about 1900, 1400 and 310 sites a frame; both packages keep
    the lowest cells), the banded and dense engines at caps that hold every
    site."""
    if engine == "gather":
        caps = (1800, 1200, 256, 128)
        cfg = small_gather_cfg(caps)
    else:
        cfg, caps = copy.deepcopy(small_cfg("float32")), (4096,) * 4
        cfg["model"]["backbone"]["impl"] = engine
    model = build_detector(cfg, device="cpu").model
    vf, vc, vv = small_voxels(3)
    count = count_forward_flops(model, {"vf": t(vf), "vc": t(vc), "vv": t(vv)})
    got = [h for _, h, _, _ in count.sparse_convs]
    assert got == _jax_hits(3, model.backbone.sparse_shape, caps)
    assert count.sparse == sum(2 * h * ci * co for _, h, ci, co in count.sparse_convs)
    if engine == "gather":  # the caps bind: without them the hits differ
        free = build_detector(small_gather_cfg((4096,) * 4), device="cpu").model
        loose = count_forward_flops(free, {"vf": t(vf), "vc": t(vc), "vv": t(vv)})
        assert [h for _, h, _, _ in loose.sparse_convs][5:] != got[5:]


def _taps(n: int, k: int, s: int, p: int) -> tuple:
    """(outputs, taps that land inside the input) of a conv along one axis."""
    outs = (n + 2 * p - k) // s + 1
    return outs, sum(1 for o in range(outs) for j in range(k) if 0 <= o * s - p + j < n)


def _rpn_head_macs(cfg, H, W, cin) -> tuple:
    """Multiply-adds of the RPN and the head from their shapes: (all taps,
    as cuDNN computes them; the taps inside the input alone, as XLA's cost
    analysis counts them)."""
    neck = cfg["model"]["neck"]
    full = inside = 0
    h, w, c, ups = H, W, cin, []

    def conv(h, w, cin, cout, k, s, p):
        nonlocal full, inside
        (oh, th), (ow, tw) = _taps(h, k, s, p), _taps(w, k, s, p)
        full += oh * ow * k * k * cin * cout
        inside += th * tw * cin * cout
        return oh, ow

    for i, n in enumerate(neck["layer_nums"]):
        f = neck["ds_num_filters"][i]
        h, w = conv(h, w, c, f, 3, neck["ds_layer_strides"][i], 1)
        for _ in range(n):
            conv(h, w, f, f, 3, 1, 1)
        c = f
        us, uf = neck["us_layer_strides"][i], neck["us_num_filters"][i]
        full += h * w * c * uf * us * us  # a transposed conv of stride us (us = 1: 1x1)
        inside += h * w * c * uf * us * us  # every output takes exactly one tap
        ups.append((h * us, w * us, uf))
    n_out = sum(t["num_class"] * 2 * (10 + t["num_class"]) for t in cfg["tasks"])
    head = ups[0][0] * ups[0][1] * sum(u[2] for u in ups) * n_out
    return full + head, inside + head


def test_dense_flops_are_shape_macs_and_near_xla():
    """The port counts every tap of a padded conv (cuDNN computes them);
    XLA's cost analysis counts the taps inside the input, plus the norms'
    and activations' elementwise work. At this 8 x 8 width the padded taps
    are 19.5 % of the RPN's and the head's multiply-adds, so XLA's figure lies between the
    inside taps' FLOPs and 1 % above them."""
    from dal3d_tpu.models.heads.mg_head import MultiGroupHead as JHead
    from dal3d_tpu.models.necks.rpn import RPN as JRPN

    cfg = small_gather_cfg()
    model = build_detector(cfg, device="cpu").model
    B, H, W, C = 2, 8, 8, 256
    x = np.random.RandomState(0).normal(0, 1, (B, H, W, C)).astype(np.float32)

    class NeckHead(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.neck, self.head = model.neck, model.head

        def forward(self, x):
            return self.head(self.neck(x))

    count = count_forward_flops(NeckHead(), {"x": t(x)})
    full, inside = _rpn_head_macs(cfg, H, W, C)
    assert count.sparse == 0 and set(count.stages) == {"neck", "head"}
    assert count.dense == 2 * B * full

    neck = cfg["model"]["neck"]
    rpn = JRPN(layer_nums=tuple(neck["layer_nums"]),
               ds_layer_strides=tuple(neck["ds_layer_strides"]),
               ds_num_filters=tuple(neck["ds_num_filters"]),
               us_layer_strides=tuple(neck["us_layer_strides"]),
               us_num_filters=tuple(neck["us_num_filters"]), num_input_features=C)
    head = JHead(num_classes=tuple(t["num_class"] for t in cfg["tasks"]))
    xj = jnp.asarray(x)
    v_rpn = jax.eval_shape(lambda a: rpn.init(jax.random.PRNGKey(0), a, False), xj)
    feat = jax.eval_shape(lambda v, a: rpn.apply(v, a, False), v_rpn, xj)
    v_head = jax.eval_shape(lambda a: head.init(jax.random.PRNGKey(1), a), feat)
    fn = jax.jit(lambda vr, vh, a: head.apply(vh, rpn.apply(vr, a, False)))
    cost = fn.lower(v_rpn, v_head, xj).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    xla = float(cost["flops"])
    assert 2 * B * inside <= xla <= 1.01 * 2 * B * inside


def test_benchmark_cli_on_the_cpu(tmp_path, capsys):
    """JAX's recipe (tools/benchmark.py:35-39) for the clouds; the harness
    on a 12.8 m config with a few thousand points; JAX's line."""
    rng = np.random.RandomState(0)
    B, P = 2, 3000
    pts = np.zeros((B, P, 5), np.float32)
    pts[..., 0] = rng.uniform(-50, 50, (B, P))
    pts[..., 1] = rng.uniform(-50, 50, (B, P))
    pts[..., 2] = rng.uniform(-4.9, 2.9, (B, P))
    assert np.array_equal(benchmark.benchmark_clouds(B, P), pts)

    path = tmp_path / "small.py"
    cfg = small_gather_cfg()
    path.write_text("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    res = benchmark.main([str(path), "--points", str(P), "--iters", "1", "--warmup", "1",
                          "--cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith(f"batch {B}: ") and lines[-1].endswith(" scans/s")
    assert res["device_ms"] is None and res["predicts"] == 2 and res["scans_per_s"] > 0

    bev = tmp_path / "bev.py"
    bev.write_text("model = {'type': 'BEVFusion'}\n")
    with pytest.raises(ValueError, match="CBGS"):
        benchmark.main([str(bev), "--cpu"])


def test_get_flops_cli_on_the_cpu(tmp_path, capsys):
    path = tmp_path / "small.py"
    cfg = dict(small_gather_cfg(), max_points=2000)
    path.write_text("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    res = get_flops.main([str(path), "--batch_size", "2", "--cpu"])
    out = capsys.readouterr().out.splitlines()
    model = build_detector(cfg, device="cpu").model
    assert out[0] == f"params: {sum(p.numel() for p in model.parameters()) / 1e6:.2f} M"
    assert out[1].startswith("forward flops (") and out[1].endswith(" GFLOP")
    # zero points: one voxel a frame, so L0's subm convs have one hit a frame
    assert [h for _, h, _, _ in res["sparse_convs"][:5]] == [2] * 5
    assert res["hits"] == sum(h for _, h, _, _ in res["sparse_convs"])
    assert res["flops"] == res["dense"] + res["sparse"]
    assert set(res["stages"]) == {"backbone", "neck", "head"}


def test_tools_without_cpu_flag_need_a_gpu(tmp_path, monkeypatch):
    """Without ``--cpu`` both CLIs go to the card: on a box without one they
    raise before any work, as every entry point of the port."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "small.py"
    path.write_text("".join(f"{k} = {v!r}\n" for k, v in small_gather_cfg().items()))
    for main in (benchmark.main, get_flops.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([str(path)])
