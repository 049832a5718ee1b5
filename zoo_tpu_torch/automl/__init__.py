"""AutoML of the port (counterpart of ``zoo_tpu/automl``): the search
space DSL (``hp``), the TPE sampler (``tpe``), the search engines
(``search``) and the metric dispatch (``common.metrics``), all on the
host."""
