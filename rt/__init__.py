"""rt — a differentiable path tracer in JAX, with Pallas GPU kernels.

A from-scratch reimplementation of the capabilities of
hucancode/hello-raytracing (Rust + wgpu + WGSL):

- ``rt.core``    pure-JAX, vmap-able, differentiable math: RNG, camera rays,
                 sphere / triangle intersection, material scatter, sky, the
                 bounce loop.  (replaces src/shaders/*.wgsl device code)
- ``rt.scene``   host-side scene construction: OBJ loading, BVH build,
                 the 7 app scenes + deterministic test scenes.
                 (replaces src/scene/*, src/geometry/*)
- ``rt.kernels`` fused Pallas kernels (Triton route) for the hot render
                 path.
- ``rt.render``  the jit-compiled render graph + progressive accumulation
                 state + PPM I/O.  (replaces src/renderer.rs, render_ppm.rs)
- ``rt.dist``    device-mesh sharding of the image plane, multi-host helpers,
                 collective image assembly.  (no reference equivalent; the
                 reference is single-GPU)
- ``rt.grad``    differentiable rendering: frozen-RNG pixel gradients,
                 finite-difference checks, inverse-rendering optimizer loops.
- ``rt.utils``   profiling / stats / logging.
- ``rt.cli``     headless scene-id CLI mirroring src/app.rs dispatch.
- ``rt.viewer``  interactive terminal viewer (orbit camera + live display).
- ``native/``    C++ host runtime (OBJ parse, BVH build, PPM) via ctypes.
"""

__version__ = "0.1.0"
