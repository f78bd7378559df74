from mitsuba_jax.parallel.mesh import (
    make_mesh,
    render_sharded,
    shard_lanes,
    training_step_sharded,
)
from mitsuba_jax.parallel.multihost import init_multihost, is_coordinator, pod_mesh
from mitsuba_jax.parallel.server import (
    DEFAULT_PORT,
    RenderClient,
    RenderServer,
    serve_pipe,
)

__all__ = [
    "make_mesh", "render_sharded", "shard_lanes", "training_step_sharded",
    "init_multihost", "is_coordinator", "pod_mesh",
    "RenderServer", "RenderClient", "serve_pipe", "DEFAULT_PORT",
]
