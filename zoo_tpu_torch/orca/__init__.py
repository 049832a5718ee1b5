"""Process supervision of the port (``orca/bootstrap.py``)."""
