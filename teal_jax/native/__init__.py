"""Native (C++) host-side kernels for the calibration pipeline.

The device compute path is jax/XLA/Pallas; the host-side runtime around it
uses C++ where it is hot: histogram construction over hundreds of
millions of captured activation values per layer (`histogram.cpp`,
OpenMP + exact O(n) order statistics, bit-identical to the numpy
semantics). Built on demand with g++ + ctypes (`loader.py`); everything
degrades to numpy when no toolchain is present.
"""

from teal_jax.native.loader import get_lib

__all__ = ["get_lib"]
