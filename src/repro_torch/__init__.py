"""PyTorch/CUDA port of the federated-learning system in ``repro``.

The package mirrors ``repro``'s subpackages (``core``, ``kernels``,
``models``, ``data``) with the same module and function names.  It imports
``torch`` and numpy only.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; without a card and without that argument they raise.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
