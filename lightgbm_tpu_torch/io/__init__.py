"""Text data loading for the port (``parser.py``)."""
