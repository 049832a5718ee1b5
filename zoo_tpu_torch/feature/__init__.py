"""Feature pipelines of the port (``text``)."""
