"""Report components of the port (``ui/components.py``)."""
