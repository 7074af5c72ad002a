"""The port's cv2-free renderer: the stroke rasterizer's cv2-named entry
points and area operations (``draw``), TrueType-glyph text from a
committed glyph table (``text``), the image codec (``image``) and video
I/O (``video``: MP4 and AVI over ``mp4`` and ``avi`` with ``mpeg4``,
``h264``, ``hevc`` and ``mjpeg``, raw H.264 and H.265, YUV4MPEG2)."""
