"""TCN forecaster: residual blocks of dilated causal convolutions
(counterpart of ``zoo_tpu/chronos/forecaster/tcn_forecaster.py``).

A block is two causal convs (left pad ``(k - 1) * d``, then a VALID conv
with the kernel dilated by ``d``; weights WIO ``(k, cin, cout)`` as the
JAX package lays them out), each followed by relu, with dropout between
them in training and a 1x1 skip conv when the channel count changes.
The convs are the reference conv (:func:`~zoo_tpu_torch.ops.kernels.
conv.conv2d_plain` over a one-row image, with its ``dilation``: f32
sums, TF32 off, a deterministic backward), outside any hand-written
kernel, as the JAX package's ``lax.conv_general_dilated`` is outside
Pallas. The dropout is the dropout kernel on JAX's mask for
``layer_rng(rng, name)``: two launches a step per block on the card.
"""

from __future__ import annotations

from typing import Optional

from zoo_tpu_torch.chronos.data.tsdataset import TSDataset
from zoo_tpu_torch.chronos.forecaster.base import Forecaster
from zoo_tpu_torch.pipeline.api.keras.engine.base import (
    Layer,
    get_initializer,
    layer_rng,
)


def causal_conv1d(x, w, dilation: int = 1):
    """(B, T, cin) through WIO ``w`` (k, cin, cout) causally: left pad
    ``(k - 1) * dilation``, the kernel dilated; (B, T, cout) out."""
    from zoo_tpu_torch.ops.kernels.conv import conv2d_plain
    pad = (int(w.shape[0]) - 1) * dilation
    return conv2d_plain(x[:, None], w[None], (1, 1), ((0, 0), (pad, 0)),
                        (1, dilation))[:, 0]


class _CausalConvBlock(Layer):
    """Residual TCN block: two dilated causal convs and a 1x1 skip."""

    def __init__(self, channels: int, kernel_size: int, dilation: int,
                 dropout: float = 0.0, **kwargs):
        super().__init__(**kwargs)
        self.channels = channels
        self.kernel_size = kernel_size
        self.dilation = dilation
        self.dropout = dropout
        self.init = get_initializer("he_normal")

    def build(self, generator, input_shape):
        cin = input_shape[-1]
        k, c = self.kernel_size, self.channels
        zero = get_initializer("zero")
        p = {"W1": self.init(generator, (k, cin, c)),
             "b1": zero(generator, (c,)),
             "W2": self.init(generator, (k, c, c)),
             "b2": zero(generator, (c,))}
        if cin != c:
            p["Wskip"] = self.init(generator, (1, cin, c))
        return p

    def call(self, params, inputs, *, training=False, rng=None):
        import torch

        from zoo_tpu_torch.ops.kernels import dropout as D
        y = torch.relu(causal_conv1d(inputs, params["W1"], self.dilation)
                       + params["b1"])
        if training and self.dropout and rng is not None:
            y = D.dropout(y, layer_rng(rng, self.name), self.dropout)
        y = torch.relu(causal_conv1d(y, params["W2"], self.dilation)
                       + params["b2"])
        skip = inputs
        if "Wskip" in params:
            skip = causal_conv1d(inputs, params["Wskip"])
        return torch.relu(y + skip)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], input_shape[1], self.channels)


class TCNForecaster(Forecaster):
    def __init__(self, past_seq_len: int, future_seq_len: int,
                 input_feature_num: int, output_feature_num: int,
                 num_channels: Optional[list] = None, kernel_size: int = 3,
                 dropout: float = 0.1, lr: float = 0.001,
                 loss: str = "mse", device=None):
        super().__init__(past_seq_len, input_feature_num,
                         output_feature_num, future_seq_len, device=device)
        self.num_channels = list(num_channels or [30, 30])
        self.kernel_size = kernel_size
        self.dropout = dropout
        self.lr = lr
        self.loss = loss
        self._ctor_args.update(future_seq_len=future_seq_len,
                               num_channels=self.num_channels,
                               kernel_size=kernel_size, dropout=dropout,
                               lr=lr, loss=loss)

    def _build(self):
        from zoo_tpu_torch.pipeline.api.keras import Sequential
        from zoo_tpu_torch.pipeline.api.keras import optimizers as zopt
        from zoo_tpu_torch.pipeline.api.keras.layers import Dense, Lambda

        m = Sequential(name="tcn_forecaster")
        for i, ch in enumerate(self.num_channels):
            blk = _CausalConvBlock(ch, self.kernel_size, dilation=2 ** i,
                                   dropout=self.dropout)
            if i == 0:
                blk.batch_input_shape = (None, self.past_seq_len,
                                         self.input_feature_num)
            m.add(blk)
        # the last timestep carries the whole receptive field
        m.add(Lambda(lambda x: x[:, -1],
                     output_shape=(self.num_channels[-1],)))
        m.add(Dense(self.future_seq_len * self.output_feature_num))
        m.compile(optimizer=zopt.Adam(lr=self.lr), loss=self.loss)
        self.model = m

    @staticmethod
    def from_tsdataset(tsdataset: TSDataset, past_seq_len: int = 24,
                       future_seq_len: int = 1, **kwargs
                       ) -> "TCNForecaster":
        if tsdataset.lookback is not None:
            past_seq_len = tsdataset.lookback
            h = tsdataset.horizon
            future_seq_len = h if isinstance(h, int) else len(h)
        return TCNForecaster(
            past_seq_len=past_seq_len, future_seq_len=future_seq_len,
            input_feature_num=tsdataset.get_feature_num(),
            output_feature_num=tsdataset.get_target_num(), **kwargs)
