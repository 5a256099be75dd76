"""PyTorch/CUDA port of the MoEntwine serving path.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``configs``, ``core``, ``parallel``, ``kernels``, ``models``, ``runtime``,
``launch``) and imports nothing of it. Hot-path kernels are hand-written
CUDA C++ for Hopper (``csrc/``), built at first use; each sits beside its
plain PyTorch version, which CPU tensors take. The paper's analytic model
(``core``: mappings, the Eq. 1 communication model, the simulator) is
numpy on the host; ``figures`` prints the paper's figures from it.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
