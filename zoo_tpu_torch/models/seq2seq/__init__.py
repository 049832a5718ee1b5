"""The RNN encoder-decoder family (counterpart of
``zoo_tpu/models/seq2seq``)."""

from zoo_tpu_torch.models.seq2seq.seq2seq import (
    Bridge,
    RNNDecoder,
    RNNEncoder,
    Seq2seq,
)

__all__ = ["Seq2seq", "RNNEncoder", "RNNDecoder", "Bridge"]
