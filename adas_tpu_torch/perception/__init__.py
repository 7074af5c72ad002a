"""Detector facades of the port (counterparts of ``adas_tpu/perception``)."""
