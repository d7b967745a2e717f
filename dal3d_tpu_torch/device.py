"""Device default of the port's entry points.

``device=None`` means the CUDA card. A box without one raises instead of
quietly running on the CPU: the CPU runs only when the caller asks for it
(``device="cpu"``, as the tests do), and then every kernel wrapper takes its
plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no GPU is present); anything else is
    passed to ``torch.device`` as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain PyTorch "
                "versions of the kernels on the CPU")
        return torch.device("cuda")
    return torch.device(device)
