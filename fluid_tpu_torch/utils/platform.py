"""Device helpers: fail loudly without a GPU, and name the card.

Counterpart of ``fluid_tpu/utils/platform.py`` for the CUDA port.  A
measurement or on-card check calls ``require_cuda()`` and never falls back
to the CPU; ``card_info()`` is printed beside every number taken on the card
(a card can be power-capped below its maximum, which changes its speed).

The entry points (``Session``, ``state``, ``scene``) put their tensors on
``default_device()``, the card, unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import subprocess

import torch


def require_cuda() -> torch.device:
    """The first CUDA device; raises RuntimeError when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this path runs only on the GPU "
            "(the CPU tests use the kernels' plain versions)"
        )
    return torch.device("cuda", 0)


def default_device() -> torch.device:
    """Where an entry point puts its state when no device is given: the
    card (``require_cuda()``, so it raises on a host without one)."""
    return require_cuda()


def cuda_devices(n=None) -> list:
    """The first ``n`` CUDA devices (None: all of them); raises
    RuntimeError when there are fewer, or none."""
    require_cuda()
    have = torch.cuda.device_count()
    n = have if n is None else n
    if n > have:
        raise RuntimeError(f"{n} CUDA devices asked for, {have} present")
    return [torch.device("cuda", i) for i in range(n)]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; None means ``default_device()``.  A
    CUDA device gets its index (``"cuda"`` is the current device), so it
    compares equal to the ``.device`` of the tensors on it."""
    device = torch.device(device) if device is not None else default_device()
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def card_info() -> str:
    """``name, power.limit`` of the cards, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()
