"""Shared kernel utilities and the Pallas backend policy.

Most of the pipeline is plain ``jax.numpy``/``lax`` code that XLA compiles
for the GPU as it stands.  The few hand-written Pallas kernels follow two
rules:

- **Every ``pallas_call`` names its route** (``backend="triton"``); the
  default route of the installed JAX is Mosaic GPU, which a kernel written
  for Triton's block model would not get.
- **Interpret mode only on the CPU**: :func:`use_interpret` returns True on
  the CPU backend (how the test suite runs, on 8 virtual devices), False on
  the GPU, and raises on any other backend, so no kernel can silently fall
  back to an interpreted grid on an accelerator.
"""

from __future__ import annotations

import jax


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def use_interpret(backend: str | None = None) -> bool:
    """Whether Pallas kernels run in interpret mode on ``backend``
    (default: ``jax.default_backend()``).

    "cpu" -> True (tests); "gpu" -> False (compiled through the kernel's
    named route); anything else raises: no kernel here has a route there.
    """
    backend = jax.default_backend() if backend is None else backend
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise RuntimeError(
        f"no Pallas route for backend {backend!r}: kernels compile for the "
        "GPU (Triton) and run interpreted on the CPU only")
