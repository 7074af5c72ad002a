"""The port's tools: the weight formats (``params_io``, ``quantize``), the
checkpoint importers (``torch_import``, ``yolo_import``,
``efficientdet_import``, ``onnx_import``) and the ONNX writer, which run
anywhere, and measurement scripts that run on a CUDA GPU."""
