"""tpufg — real-time upscaling & motion-compensated frame interpolation in JAX.

A brand-new JAX/XLA/Pallas framework with the capabilities of the reference
``xXJSONDeruloXx/linux-fg`` (C++20 + Vulkan compute).  The reference's three GLSL
compute shaders (``scale.comp``, ``motion.comp``, ``interpolate.comp``) are the
mathematical specification; everything else (Vulkan plumbing, X11 capture, SDL
display) is re-designed for an accelerator driven from JAX:

- ``tpufg.ops``      — pure-jnp f32 oracle ops transcribed 1:1 from the GLSL
                       (the executable spec; reference shaders/scale.comp:1-61,
                       motion.comp:1-57, interpolate.comp:1-40).
- ``tpufg.kernels``  — the production compute path: plain XLA ops and one
                       Pallas (Triton) kernel for the exhaustive search.
- ``tpufg.engine``   — streaming pipeline: HBM frame ring, double-buffered
                       ingest, jit'd step functions, pacing, stats (replaces
                       reference src/scaler.cpp + src/frame_manager.cpp).
- ``tpufg.io``       — frame sources/sinks + native C++ ingest (replaces
                       reference src/window_capture.cpp; no X11 on a
                       headless accelerator host).
- ``tpufg.parallel`` — multi-device spatial/temporal sharding over a
                       jax.sharding.Mesh with row-halo exchange.
- ``tpufg.models``   — hierarchical pyramid motion search and the learned
                       (RIFE-style) interpolation head.
- ``tpufg.config``   — config dataclass + CLI derivation rules (replaces
                       reference src/main.cpp:21-90 flag handling).
"""

from tpufg.version import __version__

__all__ = ["__version__"]
