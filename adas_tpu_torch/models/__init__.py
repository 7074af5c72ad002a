"""Nets of the port (counterparts of ``adas_tpu/models``)."""
