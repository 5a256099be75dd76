"""PyTorch/CUDA port of the MoEntwine serving path.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``configs``, ``core``, ``parallel``, ``kernels``, ``models``, ``runtime``,
``launch``) and imports nothing of it. Hot-path kernels are hand-written
CUDA C++ for Hopper (``csrc/``), built at first use; each sits beside its
plain PyTorch version, which CPU tensors take.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
