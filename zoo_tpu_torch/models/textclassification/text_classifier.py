"""Text classifier (counterpart of
``zoo_tpu/models/textclassification/text_classifier.py``): token ids ->
``Embedding`` -> a CNN (``Conv1D`` of width 5, relu, then a global max
pool), LSTM or GRU encoder -> ``Dropout`` -> ``Dense(128, relu)`` ->
``Dense(class_num, softmax)``. The constructor's widths are the
reference's (the Scala ``TextClassifier``): 200-wide token embeddings
over 500-token sequences, a 256-wide encoder and 20 % dropout."""

from __future__ import annotations

from zoo_tpu_torch.pipeline.api.keras.engine.topology import Sequential
from zoo_tpu_torch.pipeline.api.keras.layers import (
    GRU,
    LSTM,
    Conv1D,
    Dense,
    Dropout,
    Embedding,
    GlobalMaxPooling1D,
)


class TextClassifier(Sequential):
    def __init__(self, class_num: int, token_length: int = 200,
                 sequence_length: int = 500, vocab: int = 5000,
                 encoder: str = "cnn", encoder_output_dim: int = 256,
                 hidden_drop: float = 0.2):
        super().__init__(name="text_classifier")
        encoder = encoder.lower()
        if encoder not in ("cnn", "lstm", "gru"):
            raise ValueError("encoder must be cnn | lstm | gru")
        self.class_num = class_num
        self.add(Embedding(vocab, token_length,
                           input_shape=(sequence_length,)))
        if encoder == "cnn":
            self.add(Conv1D(encoder_output_dim, 5, activation="relu"))
            self.add(GlobalMaxPooling1D())
        elif encoder == "lstm":
            self.add(LSTM(encoder_output_dim))
        else:
            self.add(GRU(encoder_output_dim))
        if hidden_drop:
            self.add(Dropout(hidden_drop))
        self.add(Dense(128, activation="relu"))
        self.add(Dense(class_num, activation="softmax"))
