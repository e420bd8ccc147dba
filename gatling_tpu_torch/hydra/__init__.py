"""Render-delegate layer of the port (the hdGatling analog;
gatling_tpu/hydra/__init__.py).

No pxr/Hydra runtime is needed: like the JAX package, this package gives
the reference's Hydra plugin architecture (src/hdGatling/*) as a host-
embeddable API: a renderer-plugin registry, a render delegate with the
setting descriptors and supported prim types, a render pass that maps AOV
bindings onto gi.render with convergence tracking, and render buffers.
"""

from gatling_tpu_torch.hydra.delegate import (  # noqa: F401
    HdAovBinding,
    HdRenderBuffer,
    HdRenderDelegate,
    HdRendererPlugin,
    HdRenderPass,
    get_renderer_plugin,
)
