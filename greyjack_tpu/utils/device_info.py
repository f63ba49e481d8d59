"""What a measurement ran on: JAX's view of the devices and the card's own
name and power limit. Every timing the repo prints carries both."""

from __future__ import annotations

import subprocess

import jax


def jax_device():
    """{"platform", "kind", "count"} of JAX's devices, as JAX reports them."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_line():
    """The first card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them (a card set below its maximum limit runs slower under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# Published peaks per device kind (NVIDIA H100 SXM data sheet: dense rates,
# 700 W power limit). f32 is the rate outside the tensor cores, where
# HIGHEST-precision f32 matmuls run. A device that is not listed gets no
# roofline share.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "f32_flop_per_s": 67e12,
                              "f64_flop_per_s": 34e12},
}


def peaks():
    """The first device's published peaks, or None if it is not listed."""
    return PEAKS.get(jax.devices()[0].device_kind)
