"""The device a measurement runs on, named in every result.

Speed is measured on an NVIDIA GPU only: `require_gpu` refuses any other
backend, so no number from the CPU is ever reported under a device metric.
`card_info` reads the card's name and power limit from `nvidia-smi` in a
child process that never imports JAX (so it cannot take the card).
"""

from __future__ import annotations

import subprocess

import jax

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


class NoGPUError(RuntimeError):
    pass


def require_gpu():
    """The first JAX device, which must be a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise NoGPUError(
            f"JAX found no GPU (first device: {dev.platform} "
            f"{dev.device_kind!r}); measurements run on the card only")
    return dev


def card_info() -> str:
    """`nvidia-smi` name and power limit of the first card, e.g.
    "NVIDIA H100 80GB HBM3, 700.00 W"."""
    out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def device_record() -> dict:
    """{"platform", "kind", "count", "card"} of the running process."""
    dev = require_gpu()
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card_info()}
