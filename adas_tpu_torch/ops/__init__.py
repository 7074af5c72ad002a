"""Device ops of the port: preprocessing, the stem kernel, decode, NMS,
packing (counterparts of ``adas_tpu/ops``)."""
