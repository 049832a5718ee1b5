"""Reference ``zoo.orca.automl.pytorch_utils``: the hyperparameter key
constants legacy model creators read from trial configs (counterpart of
``zoo_tpu/orca/automl/pytorch_utils.py``)."""

LR_NAME = "lr"
DEFAULT_LR = 1e-3
