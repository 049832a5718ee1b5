"""The ``automl.common`` compat package."""
