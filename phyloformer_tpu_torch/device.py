"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  Without a
CUDA device, asking for the card (or asking for nothing) raises: the port never
continues silently on the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → ``cuda``; raise if the resolved device is CUDA and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' (CLI: --device cpu) "
            "to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


@contextlib.contextmanager
def tf32_products(allow: bool) -> Iterator[None]:
    """PyTorch's own fp32 products on the card (cuBLAS matmuls, cuDNN
    convolutions) in one TF32 pass (``allow``) or in IEEE fp32 for the body
    of the ``with``; the previous settings are restored after it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
