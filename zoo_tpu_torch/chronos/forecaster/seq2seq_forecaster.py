"""Seq2Seq forecaster: an LSTM encoder whose final state seeds, through
a dense bridge, an LSTM decoder that reads the previous target step
(counterpart of ``zoo_tpu/chronos/forecaster/seq2seq_forecaster.py``),
built on the port's Seq2seq (``models/seq2seq``). Teacher forcing for
the first epochs, then a free-running fine-tune; greedy decoding in
``predict``. No dropout runs on its path (the JAX forecaster takes a
``dropout`` argument and builds no dropout layer), so a training step
launches only the key chain's split on the card.
"""

from __future__ import annotations

import numpy as np

from zoo_tpu_torch.chronos.data.tsdataset import TSDataset
from zoo_tpu_torch.chronos.forecaster.base import (
    Forecaster,
    compute_metrics,
)


class Seq2SeqForecaster(Forecaster):
    def __init__(self, past_seq_len: int, future_seq_len: int,
                 input_feature_num: int, output_feature_num: int,
                 lstm_hidden_dim: int = 64, lstm_layer_num: int = 1,
                 dropout: float = 0.1, lr: float = 0.001,
                 loss: str = "mse", device=None):
        super().__init__(past_seq_len, input_feature_num,
                         output_feature_num, future_seq_len, device=device)
        self.hidden = lstm_hidden_dim
        self.layer_num = lstm_layer_num
        self.dropout = dropout
        self.lr = lr
        self.loss = loss
        self._ctor_args.update(future_seq_len=future_seq_len,
                               lstm_hidden_dim=lstm_hidden_dim,
                               lstm_layer_num=lstm_layer_num,
                               dropout=dropout, lr=lr, loss=loss)

    def _build(self):
        from zoo_tpu_torch.models.seq2seq import (
            Bridge,
            RNNDecoder,
            RNNEncoder,
            Seq2seq,
        )
        from zoo_tpu_torch.pipeline.api.keras import optimizers as zopt
        from zoo_tpu_torch.pipeline.api.keras.layers import Dense

        enc = RNNEncoder.initialize("lstm", self.layer_num, self.hidden)
        dec = RNNDecoder.initialize("lstm", self.layer_num, self.hidden)
        m = Seq2seq(enc, dec,
                    (self.past_seq_len, self.input_feature_num),
                    (self.future_seq_len, self.output_feature_num),
                    Bridge.initialize("dense", self.hidden),
                    Dense(self.output_feature_num),
                    name="seq2seq_forecaster")
        m.compile(optimizer=zopt.Adam(lr=self.lr), loss=self.loss)
        self.model = m

    # -- teacher-forced fit / greedy predict ------------------------------
    def _start_token(self, x):
        """The first decoder input: the last observed target value when
        the targets lead the input features (TSDataset's layout), else
        zeros."""
        if self.input_feature_num >= self.output_feature_num:
            return x[:, -1:, :self.output_feature_num]
        return np.zeros((len(x), 1, self.output_feature_num),
                        np.float32)

    def _teacher_inputs(self, x, y):
        """The decoder's input in teacher forcing: [start token,
        y[:-1]]."""
        return np.concatenate([self._start_token(x), y[:, :-1]], axis=1)

    def _set_self_feed(self, flag: bool):
        """Flip the decoder between teacher-forced and free-running
        training (the eager model holds no compiled step to drop)."""
        self.model._core.train_self_feed = flag

    def _compile(self, lr: float):
        from zoo_tpu_torch.pipeline.api.keras import optimizers as zopt
        self.model.compile(optimizer=zopt.Adam(lr=lr), loss=self.loss)
        self._compiled_lr = lr

    def fit(self, data, epochs: int = 1, batch_size: int = 32,
            validation_data=None, seed: int = 0,
            free_run_ratio: float = 0.3):
        """Teacher forcing for the first ``1 - free_run_ratio`` of the
        epochs (all of them under 3 epochs), then a free-running
        fine-tune, the decoder reading its own predictions, with a fresh
        Adam at 0.4 of the rate."""
        x, y = self._unpack(data)
        if y is None:
            raise ValueError("fit requires rolled targets")
        y = np.asarray(y).reshape(len(y), self.future_seq_len,
                                  self.output_feature_num)
        self._ensure_model()
        dec_in = self._teacher_inputs(np.asarray(x), y)
        val = None
        if validation_data is not None:
            vx, vy = self._unpack(validation_data)
            vy = np.asarray(vy).reshape(len(vy), self.future_seq_len,
                                        self.output_feature_num)
            val = ([np.asarray(vx), self._teacher_inputs(
                np.asarray(vx), vy)], vy)
        free_epochs = int(epochs * free_run_ratio) if epochs >= 3 else 0
        teacher_epochs = epochs - free_epochs
        dev = self._device()
        hist = {}
        try:
            self._set_self_feed(False)
            if getattr(self, "_compiled_lr", self.lr) != self.lr:
                # a previous fit left the fine-tune optimizer compiled in
                self._compile(self.lr)
            if teacher_epochs:
                h = self.model.fit([np.asarray(x), dec_in], y,
                                   batch_size=min(batch_size, len(x)),
                                   nb_epoch=teacher_epochs,
                                   validation_data=val, verbose=0,
                                   seed=seed, device=dev)
                for k, v in h.items():
                    hist.setdefault(k, []).extend(v)
            if free_epochs:
                self._set_self_feed(True)
                # a fresh optimizer at a gentler rate: free-running
                # gradients are noisier (BPTT through the feedback)
                self._compile(self.lr * 0.4)
                h = self.model.fit([np.asarray(x), dec_in], y,
                                   batch_size=min(batch_size, len(x)),
                                   nb_epoch=free_epochs,
                                   validation_data=val, verbose=0,
                                   seed=seed + teacher_epochs, device=dev)
                for k, v in h.items():
                    hist.setdefault(k, []).extend(v)
        finally:
            self._set_self_feed(False)
        self.fitted = True
        return hist

    def predict(self, data, batch_size: int = 256) -> np.ndarray:
        x, _ = self._unpack(data)
        x = np.asarray(x)
        self._ensure_model()
        # greedy decoding: step 0 reads the start token, later steps the
        # model's own predictions
        dec = np.zeros((len(x), self.future_seq_len,
                        self.output_feature_num), np.float32)
        dec[:, :1] = self._start_token(x)
        out = self.model.predict([x, dec],
                                 batch_size=min(batch_size, len(x)),
                                 device=self._device())
        return np.asarray(out).reshape(len(x), self.future_seq_len,
                                       self.output_feature_num)

    def evaluate(self, data, metrics=("mse",), batch_size: int = 256):
        x, y = self._unpack(data)
        preds = self.predict((x, None), batch_size=batch_size)
        y = np.asarray(y).reshape(preds.shape)
        return compute_metrics(y, preds, metrics)

    @staticmethod
    def from_tsdataset(tsdataset: TSDataset, past_seq_len: int = 24,
                       future_seq_len: int = 1, **kwargs
                       ) -> "Seq2SeqForecaster":
        if tsdataset.lookback is not None:
            past_seq_len = tsdataset.lookback
            h = tsdataset.horizon
            future_seq_len = h if isinstance(h, int) else len(h)
        return Seq2SeqForecaster(
            past_seq_len=past_seq_len, future_seq_len=future_seq_len,
            input_feature_num=tsdataset.get_feature_num(),
            output_feature_num=tsdataset.get_target_num(), **kwargs)
