"""Training pipelines of the port (counterpart of ``zoo_tpu/pipeline``)."""
