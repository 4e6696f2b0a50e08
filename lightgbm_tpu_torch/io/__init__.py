"""Text data loading (``parser.py``: ``load_data_file``, the streaming
chunks), the serving RPC's framing and the socket net (``net.py``), and the
distributed loader (``distributed.py``)."""

from .parser import load_data_file

__all__ = ["load_data_file"]
