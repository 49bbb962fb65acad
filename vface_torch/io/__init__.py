"""Video IO: Y4M, AVI, WAV and GIF (``io/video.py``) and the PNG frames (``io/image.py``)."""
