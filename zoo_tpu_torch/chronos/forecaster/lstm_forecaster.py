"""LSTM forecaster: stacked ``LSTM`` layers, each followed by
``Dropout``, and a ``Dense`` head (counterpart of
``zoo_tpu/chronos/forecaster/lstm_forecaster.py``). In training each
dropout launches the dropout kernel twice a step on the card (forward,
backward)."""

from __future__ import annotations

from typing import Sequence, Union

from zoo_tpu_torch.chronos.data.tsdataset import TSDataset
from zoo_tpu_torch.chronos.forecaster.base import Forecaster


def _optimizer(name: str, lr: float):
    from zoo_tpu_torch.pipeline.api.keras import optimizers as zopt
    return {"adam": zopt.Adam, "sgd": zopt.SGD,
            "rmsprop": zopt.RMSprop}[name.lower()](lr=lr)


class LSTMForecaster(Forecaster):
    def __init__(self, past_seq_len: int, input_feature_num: int,
                 output_feature_num: int,
                 hidden_dim: Union[int, Sequence[int]] = 32,
                 layer_num: int = 1, dropout: float = 0.1,
                 lr: float = 0.001, loss: str = "mse",
                 optimizer: str = "adam", future_seq_len: int = 1,
                 device=None):
        super().__init__(past_seq_len, input_feature_num,
                         output_feature_num, future_seq_len=future_seq_len,
                         device=device)
        self.hidden_dim = ([hidden_dim] * layer_num
                           if isinstance(hidden_dim, int) else
                           list(hidden_dim))
        self.dropout = dropout
        self.lr = lr
        self.loss = loss
        self.optimizer_name = optimizer
        self._ctor_args.update(hidden_dim=self.hidden_dim, dropout=dropout,
                               lr=lr, loss=loss, optimizer=optimizer,
                               future_seq_len=future_seq_len)

    def _build(self):
        from zoo_tpu_torch.pipeline.api.keras import Sequential
        from zoo_tpu_torch.pipeline.api.keras.layers import (
            LSTM,
            Dense,
            Dropout,
        )

        m = Sequential(name="lstm_forecaster")
        for i, h in enumerate(self.hidden_dim):
            last = i == len(self.hidden_dim) - 1
            kwargs = {"input_shape": (self.past_seq_len,
                                      self.input_feature_num)} if i == 0 \
                else {}
            m.add(LSTM(h, return_sequences=not last, **kwargs))
            if self.dropout:
                m.add(Dropout(self.dropout))
        m.add(Dense(self.output_feature_num * self.future_seq_len))
        m.compile(optimizer=_optimizer(self.optimizer_name, self.lr),
                  loss=self.loss)
        self.model = m

    @staticmethod
    def from_tsdataset(tsdataset: TSDataset, past_seq_len: int = 24,
                       **kwargs) -> "LSTMForecaster":
        if tsdataset.lookback is not None:
            past_seq_len = tsdataset.lookback
        return LSTMForecaster(
            past_seq_len=past_seq_len,
            input_feature_num=tsdataset.get_feature_num(),
            output_feature_num=tsdataset.get_target_num(), **kwargs)
