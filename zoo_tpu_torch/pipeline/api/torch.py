"""``zoo.pipeline.api.torch`` of the reference (counterpart of
``zoo_tpu/pipeline/api/torch.py``): ``TorchModel.from_pytorch`` traces a
torch module into a trainable model of the port
(:mod:`zoo_tpu_torch.bridges.fx_bridge`), ``TorchLoss.from_pytorch``
hands a torch loss to the Orca torch estimator, and ``TorchOptim``
maps a torch optimizer onto the Keras-facade optimizers.
"""

from __future__ import annotations


class TorchModel:
    @staticmethod
    def from_pytorch(module, example_inputs=None, input_shape=None):
        """Trace a torch ``nn.Module`` into a trainable model of the
        port. Give ``example_inputs`` (preferred) or an ``input_shape``
        from which a float example is drawn."""
        import torch

        from zoo_tpu_torch.pipeline.api.net import Net

        if example_inputs is None:
            if input_shape is None:
                raise ValueError(
                    "from_pytorch needs example_inputs=[tensor,...] or "
                    "input_shape=(...) to trace the module")
            example_inputs = [torch.randn(*input_shape)]
        return Net.load_torch(module, example_inputs)


class TorchLoss:
    """Wraps a torch loss for the Orca torch estimator, which takes torch
    losses directly."""

    @staticmethod
    def from_pytorch(criterion):
        return criterion


class TorchOptim:
    """A torch optimizer as the Keras-facade optimizer the traced model
    trains with (the JAX package's mapping: SGD with its momentum, AdamW
    with its weight decay, RMSprop, else Adam, each at the first param
    group's rate)."""

    @staticmethod
    def from_pytorch(optimizer):
        import torch

        from zoo_tpu_torch.pipeline.api.keras import optimizers as zopt

        lr = optimizer.param_groups[0].get("lr", 1e-3) \
            if hasattr(optimizer, "param_groups") else 1e-3
        if isinstance(optimizer, torch.optim.SGD):
            mom = optimizer.param_groups[0].get("momentum", 0.0)
            return zopt.SGD(lr=lr, momentum=mom)
        if isinstance(optimizer, torch.optim.AdamW):
            wd = optimizer.param_groups[0].get("weight_decay", 0.01)
            return zopt.AdamWeightDecay(lr=lr, weight_decay=wd)
        if isinstance(optimizer, torch.optim.RMSprop):
            return zopt.RMSprop(lr=lr)
        return zopt.Adam(lr=lr)
