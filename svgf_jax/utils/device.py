"""Device checks shared by the measurement entry points (bench.py,
chip_smoke.py): they run on a GPU or not at all, and every result they
print names the card it ran on."""

from __future__ import annotations

import subprocess

import jax


def require_gpu() -> jax.Device:
    """The first device, which must be a GPU: a measurement never falls
    back to the CPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {dev.platform} ({dev.device_kind})")
    return dev


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def device_record() -> dict:
    """{"platform", "kind", "count"} of the devices JAX sees."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def peak_bytes(dev: jax.Device | None = None) -> int:
    """Peak device memory the process's arrays have held so far."""
    dev = dev or jax.devices()[0]
    return int((dev.memory_stats() or {}).get("peak_bytes_in_use", 0))
