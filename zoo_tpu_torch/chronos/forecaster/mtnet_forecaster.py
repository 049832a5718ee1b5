"""MTNet forecaster, a memory-network time-series model (counterpart of
``zoo_tpu/chronos/forecaster/mtnet_forecaster.py``).

The lookback window splits into ``n`` long-term memory blocks and one
short-term query block; one shared ``Convolution1D`` + ``GRU`` encoder
embeds each, a softmax over the memory embeddings' scores against the
query picks a context, and a ``Dense`` head over [context; query] plus a
linear autoregressive skip over the last ``ar_window`` raw steps gives
the forecast. A functional ``Model`` with shared layer instances, so the
encoder's weights are one set under the same keys as the JAX package's.
No dropout runs on its path: a training step launches only the key
chain's split on the card.
"""

from __future__ import annotations

import torch

from zoo_tpu_torch.chronos.forecaster.base import Forecaster
from zoo_tpu_torch.pipeline.api.keras.layers import Merge


class _Attend(Merge):
    """Softmax over the memory blocks' scores against the query; the
    context out."""

    def __init__(self, **kw):
        super().__init__(mode="dot", **kw)

    def call(self, params, inputs, *, training=False, rng=None):
        *ms, u = inputs
        m = torch.stack(ms, dim=1)                      # (B, n, H)
        score = torch.einsum("bnh,bh->bn", m, u)
        p = torch.exp(score - score.amax(-1, keepdim=True))
        p = p / p.sum(-1, keepdim=True)
        return torch.einsum("bn,bnh->bh", p, m)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[-1])


class MTNetForecaster(Forecaster):
    def __init__(self, target_dim: int = 1, feature_dim: int = 1,
                 long_series_num: int = 1, series_length: int = 1,
                 ar_window_size: int = 1, cnn_height: int = 1,
                 cnn_hid_size: int = 32, rnn_hid_size: int = 32,
                 lr: float = 0.001, loss: str = "mse", device=None):
        past = (long_series_num + 1) * series_length
        super().__init__(past_seq_len=past, input_feature_num=feature_dim,
                         output_feature_num=target_dim, future_seq_len=1,
                         device=device)
        self.n = int(long_series_num)
        self.T = int(series_length)
        self.ar_window = int(ar_window_size)
        self.cnn_height = int(cnn_height)
        self.cnn_hid = int(cnn_hid_size)
        self.rnn_hid = int(rnn_hid_size)
        self.lr = lr
        self.loss = loss
        # replaced, not updated: TSPipeline.load rebuilds by
        # cls(**ctor_args), and the base keys are no MTNet arguments
        self._ctor_args = dict(
            target_dim=target_dim, feature_dim=feature_dim,
            long_series_num=long_series_num, series_length=series_length,
            ar_window_size=ar_window_size, cnn_height=cnn_height,
            cnn_hid_size=cnn_hid_size, rnn_hid_size=rnn_hid_size,
            lr=lr, loss=loss)

    def _build(self):
        from zoo_tpu_torch.pipeline.api.keras import optimizers as zopt
        from zoo_tpu_torch.pipeline.api.keras.engine.topology import (
            Input,
            Model,
        )
        from zoo_tpu_torch.pipeline.api.keras.layers import (
            GRU,
            Convolution1D,
            Dense,
            Lambda,
        )

        n, T, D = self.n, self.T, self.input_feature_num
        out_dim = self.output_feature_num
        inp = Input(shape=(self.past_seq_len, D))
        # the shared encoder: Conv1D over time, then the GRU's last state
        conv = Convolution1D(self.cnn_hid, min(self.cnn_height, T),
                             border_mode="same", activation="relu")
        gru = GRU(self.rnn_hid, return_sequences=False)

        def block(i):
            sl = Lambda(lambda v, i=i: v[:, i * T:(i + 1) * T],
                        output_shape=(T, D))(inp)
            return gru(conv(sl))

        mem = [block(i) for i in range(n)]       # n x (B, H)
        query = block(n)                          # (B, H), the last block
        context = _Attend()(mem + [query])
        joined = Merge(mode="concat")([context, query])
        nonlinear = Dense(out_dim)(joined)
        # the autoregressive skip: linear over the last ar_window raw steps
        ar_in = Lambda(
            lambda v: v[:, -self.ar_window:, :out_dim].reshape(
                (v.shape[0], self.ar_window * out_dim)),
            output_shape=(self.ar_window * out_dim,))(inp)
        linear = Dense(out_dim, bias=False)(ar_in)
        out = Merge(mode="sum")([nonlinear, linear])
        m = Model(input=inp, output=out, name="mtnet")
        m.compile(optimizer=zopt.Adam(lr=self.lr), loss=self.loss)
        self.model = m

    @staticmethod
    def from_tsdataset(tsdataset, past_seq_len: int = 24,
                       future_seq_len: int = 1, **kwargs):
        if future_seq_len != 1:
            raise ValueError("MTNet forecasts one step (reference "
                             "constraint)")
        if past_seq_len < 4 or past_seq_len % 2:
            raise ValueError(
                f"MTNet needs an even past_seq_len >= 4 (got "
                f"{past_seq_len}): the window splits into memory blocks "
                "plus a query block of equal length")
        d = tsdataset.get_feature_num()
        fc = MTNetForecaster(target_dim=tsdataset.get_target_num(),
                             feature_dim=d, long_series_num=1,
                             series_length=past_seq_len // 2, **kwargs)
        tsdataset.roll(fc.past_seq_len, 1)
        return fc
