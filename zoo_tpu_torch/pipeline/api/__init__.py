"""User-facing APIs of the port's pipelines."""
