"""mitsuba_jax — a differentiable wavefront Monte Carlo path tracer in JAX.

A from-scratch re-design of the rendering capabilities of Mitsuba 0.2.1
(reference: /root/reference) as a wavefront renderer built on
jax/XLA/pallas/shard_map. See ARCHITECTURE.md for the design map.
"""

__version__ = "0.1.0"

from mitsuba_jax.core.registry import register_plugin, create_plugin, plugin_names

__all__ = ["register_plugin", "create_plugin", "plugin_names", "__version__"]
