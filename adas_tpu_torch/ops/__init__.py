"""Device ops of the port: preprocessing, the stem, int8 conv, fused
block, IoU and NMS-scan kernels, decode, packing (counterparts of
``adas_tpu/ops``)."""
