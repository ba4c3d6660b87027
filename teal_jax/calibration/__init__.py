from teal_jax.calibration.grab_acts import calibrate
from teal_jax.calibration.thresholds import (
    thresholds_for_uniform,
    thresholds_from_sparsities,
    get_layer_greedy_sparsities,
)
from teal_jax.calibration.greedyopt import process_layer, proj_weights

__all__ = [
    "calibrate",
    "thresholds_for_uniform",
    "thresholds_from_sparsities",
    "get_layer_greedy_sparsities",
    "process_layer",
    "proj_weights",
]
