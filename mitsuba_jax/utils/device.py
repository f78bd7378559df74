"""The accelerator a measurement ran on. Every reported time or rate names
it: JAX's platform, device kind and count, and the card's name and power
limit as nvidia-smi reports them (a card set below its maximum power
runs slower under load)."""
from __future__ import annotations

import subprocess

import jax


def require_gpu() -> dict:
    """JAX's view of the devices; raises SystemExit when the default
    backend is not a GPU (measurements never fall back to the CPU)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default platform is {dev.platform!r}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` output, one line per
    card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
