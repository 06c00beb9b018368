"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  Without a
CUDA device, asking for the card (or asking for nothing) raises: the port never
continues silently on the CPU.  On the CPU, :func:`resolve_device` first warms
torch's vector math (:func:`warm_cpu_math`), so that a fresh process's answers
are the same bits as the next one's.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch


# torch's float32 exp, erf, tanh, log and sqrt on the CPU hand each thread's
# share of a contiguous tensor to MKL's vector math (VML), linked into
# libtorch_cpu.  In a fresh process, when the first call of such a function
# starts on several threads at once, one thread's contiguous share has come
# out off (erf 2.4e-4 relative, exp 1.5e-4, tanh 9.1e-5), and the next call
# is right: 8 of 540 fresh processes of a 4M-element first call on 32
# threads, 6 processes at once (``tools/first_call_check.py``).  The first
# call made on one thread, then once on the thread pool, left every call
# right (0 of 540, ``--warm``).
_VML_FUNCTIONS = (torch.exp, torch.erf, torch.tanh, torch.log, torch.sqrt, torch.log1p)
_cpu_math_warm = False


def warm_cpu_math() -> None:
    """Make the first call of each vector-math function this process's CPU
    paths use: on one thread (8 elements, under the parallel grain), then on
    the thread pool.  Idempotent; the CPU branch of :func:`resolve_device`
    calls it, so every CPU entry point of the port runs after it."""
    global _cpu_math_warm
    if _cpu_math_warm:
        return
    for fn in _VML_FUNCTIONS:
        fn(torch.ones(8))
    for fn in _VML_FUNCTIONS:
        fn(torch.ones(1 << 21))
    _cpu_math_warm = True


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → ``cuda``; raise if the resolved device is CUDA and absent.
    ``cpu`` warms the vector math first (:func:`warm_cpu_math`)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' (CLI: --device cpu) "
            "to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cpu":
        warm_cpu_math()
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
