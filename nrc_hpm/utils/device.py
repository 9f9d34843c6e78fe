"""The device a measurement runs on: JAX's view of it, and the card's name
and power limit, which every printed time carries."""

from __future__ import annotations

import subprocess

import jax


def describe() -> dict:
    """{"platform", "kind", "count"} as JAX reports the devices."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """describe(), or SystemExit when JAX found no GPU: a measurement never
    falls back to the CPU."""
    dev = describe()
    if dev["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {dev['platform']} "
                         f"({dev['kind']})")
    return dev


def card_lines() -> list[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` output, one line per
    card, e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]
