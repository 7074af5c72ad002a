"""The port's native (C++) pieces: the LAPJV solver of the tracker,
``lapjv.cpp``, built with g++ into ``adas_tpu_torch/_build/`` on first use."""
from .lapjv import lapjv, lapjv_square

__all__ = ["lapjv", "lapjv_square"]
