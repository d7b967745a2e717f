"""Environment report of the port (the counterpart of
``dal3d_tpu/utils/collect_env.py``): Python, torch, CUDA, ``nvcc`` and the
cards, for bug reports and logs.

Run: ``python -m dal3d_tpu_torch.utils.collect_env``.
"""
from __future__ import annotations

import platform
import subprocess
import sys


def collect_env() -> dict:
    info = {
        "sys.platform": sys.platform,
        "python": sys.version.replace("\n", " "),
        "machine": platform.machine(),
    }
    try:
        import torch

        info["torch"] = torch.__version__
        info["torch.version.cuda"] = str(torch.version.cuda)
        info["cuda available"] = torch.cuda.is_available()
        if torch.cuda.is_available():
            info["devices"] = ", ".join(
                f"{torch.cuda.get_device_name(i)} (sm_{''.join(map(str, torch.cuda.get_device_capability(i)))})"
                for i in range(torch.cuda.device_count()))
    except Exception as e:  # a broken install raises OSError / RuntimeError
        info["torch"] = f"unavailable ({type(e).__name__})"
    try:
        from ..ops._build import nvcc

        out = subprocess.run([nvcc(), "--version"], capture_output=True, text=True)
        info["nvcc"] = out.stdout.strip().splitlines()[-1] if out.returncode == 0 else "error"
    except Exception as e:
        info["nvcc"] = f"unavailable ({type(e).__name__})"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,driver_version",
                              "--format=csv,noheader"], capture_output=True, text=True)
        info["nvidia-smi"] = out.stdout.strip() if out.returncode == 0 else "error"
    except Exception as e:
        info["nvidia-smi"] = f"unavailable ({type(e).__name__})"
    for mod in ("numpy", "triton"):
        try:
            info[mod] = getattr(__import__(mod), "__version__", "?")
        except Exception as e:
            info[mod] = f"unavailable ({type(e).__name__})"
    return info


def main() -> None:
    for k, v in collect_env().items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
