"""Device ops of the port: preprocessing, the stem, int8 conv and fused
block kernels, decode, NMS, packing (counterparts of ``adas_tpu/ops``)."""
