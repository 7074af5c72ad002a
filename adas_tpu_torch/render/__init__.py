"""The port's cv2-free renderer: the stroke rasterizer's cv2-named entry
points and area operations (``draw``), TrueType-glyph text from a
committed glyph table (``text``), the image codec (``image``) and video
I/O (``video``: MP4 over ``mp4`` with ``mpeg4`` and ``h264``, raw H.264,
YUV4MPEG2)."""
