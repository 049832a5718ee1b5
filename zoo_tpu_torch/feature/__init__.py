"""Feature pipelines of the port: ``common`` (the Preprocessing
algebra), ``image``, ``image3d`` and ``text``."""
