"""The port's cv2-free renderer: the stroke rasterizer's cv2-named entry
points and area operations (``draw``), TrueType-glyph text from a
committed glyph table (``text``) and YUV4MPEG2 video I/O (``video``)."""
