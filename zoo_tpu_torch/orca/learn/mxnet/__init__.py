"""MXNet fabric shim (counterpart of ``zoo_tpu/orca/learn/mxnet``; the
reference's MXNet estimator over a kvstore parameter server).

MXNet has no CUDA backend in the port, and the kvstore maps onto the
one fabric, ``torch.distributed`` under ROADMAP A.14. The reference
import path resolves and redirects."""


class Estimator:
    @staticmethod
    def from_mxnet(*args, **kwargs):
        raise NotImplementedError(
            "MXNet is not a frontend of the port. Port the model to "
            "torch: orca.learn.pytorch Estimator.from_torch traces any "
            "torch module; gluon models usually translate 1:1")


def create_config(log_interval=10, optimizer="sgd",
                  optimizer_params=None, seed=None, **extra_config):
    """The reference's ``mxnet/utils.py`` ``create_config``: the trainer
    config dict MXNet estimators took. Kept so reference scripts reach
    the redirect above with their config intact."""
    config = {"log_interval": log_interval, "optimizer": optimizer,
              "optimizer_params": optimizer_params or {}}
    if seed is not None:
        config["seed"] = seed
    config.update(extra_config)
    return config
