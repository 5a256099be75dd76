"""Device resolution for the port's entry points.

Entry points (``Server``, ``init_params``, ``launch/serve.py``) run on the
card unless the caller names the CPU. Asking for CUDA on a machine without
a card raises: a serving path never carries on silently on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The ``torch.device`` to run on, with the CUDA index made explicit
    (``cuda`` -> ``cuda:<current>``) so it compares equal to the device of
    tensors allocated there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(dev)!r} requested but torch.cuda.is_available() "
                f"is False; pass device='cpu' explicitly to run the plain "
                f"PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
