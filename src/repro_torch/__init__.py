"""PyTorch/CUDA port of the Justitia serving stack.

Mirrors the layout of the JAX package ``repro`` module for module; the JAX
package is the reference the port is tested against.  Device entry points
(``Model``, ``ServeEngine``, the kernel wrappers) run on ``cuda`` unless the
caller passes ``device="cpu"``, and raise when CUDA is absent and no device
was named.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
