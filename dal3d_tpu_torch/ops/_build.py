"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
alone (no PyTorch headers, so a build takes seconds) into
``build/kernels/lib<name>_<hash>.so`` under the repository root, then loaded
with ctypes. The hash covers the source, the shared header and the flags, so
a library is rebuilt only when one of them changes. Nothing is compiled at
import time: the first kernel launch, or ``build_all``, builds.

``function`` hands a wrapper its launch function with the ctypes argument
types set once, when the library loads: a launch then costs the call itself,
with a device guard only when the tensors' card is not the current one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMMON_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas=-v")
# per-kernel extra flags: the IoU clip's eps branches compare against 1e-4
# and must see the same rounding as the plain version, so no FMA contraction
KERNELS = {
    "banded_conv": (),
    "banded_dw": (),
    "gather": (),
    "iou_matrix": ("-fmad=false",),
    "pairwise_distance": (),
    "pairwise_l2_tf32": (),
}

_lock = threading.Lock()
_libs: dict = {}
_functions: dict = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")
    return found


def _flags(name: str):
    return (*ARCH_FLAGS, *COMMON_FLAGS, *KERNELS[name])


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str, out: Path):
    """Start nvcc for one source into a temporary file; (proc, tmp)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, proc, tmp: Path, out: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial .so
    return log


def build_all(names=None) -> dict:
    """Compile every kernel whose library is missing, one nvcc per source,
    all started together. Returns {name: (seconds, compiler log)}; a kernel
    already built reports (0.0, "cached")."""
    names = list(KERNELS) if names is None else list(names)
    with _lock:
        started = {}
        t0 = time.perf_counter()
        result = {}
        for name in names:
            out = _lib_path(name)
            if out.exists():
                result[name] = (0.0, "cached")
            else:
                started[name] = (*_start(name, out), out)
        errors = []
        for name, (proc, tmp, out) in started.items():
            try:
                log = _finish(name, proc, tmp, out)
                result[name] = (time.perf_counter() - t0, log)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return result


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    out = _lib_path(name)
    if not out.exists():
        build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(out))
            lib.dal3d_error_string.argtypes = [ctypes.c_int]
            lib.dal3d_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch function."""
    if err != 0:
        msg = lib.dal3d_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


class Launch:
    """One C launch function of a kernel library, bound once: ``argtypes``
    (every argument but the trailing stream) and ``restype`` are set when it
    is first asked for. ``launch(device, *args)`` calls it on the current
    stream of ``device`` and raises on a nonzero cudaError_t."""

    __slots__ = ("lib", "fn", "what")

    def __init__(self, lib: ctypes.CDLL, fn_name: str, argtypes, what: str):
        self.lib, self.what = lib, what
        self.fn = getattr(lib, fn_name)
        self.fn.argtypes = [*argtypes, ctypes.c_void_p]
        self.fn.restype = ctypes.c_int

    def __call__(self, device: torch.device, *args) -> None:
        index, current = device.index, torch._C._cuda_getDevice()
        if index is None or index == current:
            err = self.fn(*args, torch._C._cuda_getCurrentRawStream(current))
        else:
            with torch.cuda.device(index):
                err = self.fn(*args, torch._C._cuda_getCurrentRawStream(index))
        if err != 0:
            check(self.lib, err, self.what)


def function(name: str, fn_name: str, argtypes, what: str | None = None) -> Launch:
    """The launch function ``fn_name`` of ``csrc/<name>.cu`` (built and
    loaded on first use), bound once with ``argtypes`` plus the stream."""
    launch = _functions.get((name, fn_name))
    if launch is None:
        launch = Launch(load(name), fn_name, argtypes, what or fn_name)
        _functions[(name, fn_name)] = launch
    return launch
