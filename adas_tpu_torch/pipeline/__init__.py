"""Serving pipelines of the port (counterparts of ``adas_tpu/pipeline``)."""
