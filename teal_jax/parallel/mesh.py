"""Device mesh construction.

Axes: "dp" (data/batch) × "tp" (tensor/model). The reference implements only
1-D NCCL tensor parallelism (`gpt-fast/tp.py:36-156`, torchrun + all_reduce
hooks); here parallelism is expressed as shardings over a
`jax.sharding.Mesh` and XLA inserts the collectives (all-reduce for the
rowwise-sharded projections).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(tp: Optional[int] = None, dp: int = 1,
              devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if tp is None:
        tp = n // dp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} devices")
    arr = np.asarray(devices).reshape(dp, tp)
    return Mesh(arr, axis_names=("dp", "tp"))
