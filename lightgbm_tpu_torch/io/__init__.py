"""Text data loading (``parser.py``) and the serving RPC's framing
(``net.py``)."""
