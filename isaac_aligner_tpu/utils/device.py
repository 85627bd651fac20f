"""What the default device offers this process."""

from __future__ import annotations

import os


def device_bytes() -> int:
    """Memory the default device lets this process use: its allocator's
    `bytes_limit`, or host RAM for a device that reports none (CPU)."""
    import jax
    stats = jax.devices()[0].memory_stats()
    if stats and "bytes_limit" in stats:
        return int(stats["bytes_limit"])
    return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def require_gpu():
    """The default device, which must be a GPU: measurement entry points
    never carry on on another backend."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default device is {dev.platform} "
            f"({dev.device_kind}); this runs only on the card")
    return dev


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi`'s name and power limit of each card, one per line."""
    import subprocess
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
