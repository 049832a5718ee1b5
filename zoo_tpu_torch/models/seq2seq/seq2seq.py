"""Generic RNN encoder-decoder with a bridge, teacher forcing and greedy
inference (counterpart of ``zoo_tpu/models/seq2seq/seq2seq.py``).

``RNNEncoder``/``RNNDecoder`` stack recurrent layers, ``Bridge`` maps
the encoder's final states to the decoder's initial states (dense,
densenonlinear, customized, or none: passthrough), the decoder reads the
target sequence in training (teacher forcing) and its own outputs at
inference (greedy self-feeding), and ``generator`` maps the decoder's
outputs to the result. The core drives the port's cells directly
(``_init_carry(batch, device)`` and ``_step``), so the weights are the
recurrent layers' own ``W``/``U``/``b`` under ``enc_i``/``dec_i``, with
``bridge`` (``w``, ``b``, or the custom layer's tree) and ``gen`` beside
them, as the JAX package lays them out.

The JAX package runs each direction as one ``lax.scan``; here the
recurrence is a Python loop over time in the port's idiom
(``layers/recurrent.py``): each layer's input projection is one GEMM
over every step, then one ``h @ U`` and the gates' elementwise ops a
step. Greedy decoding cannot hoist the projection (each step's input is
the last step's output), so it runs layer by layer inside the loop.
None of it reaches a hand-written kernel: the JAX package computes it
outside Pallas.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from zoo_tpu_torch.pipeline.api.keras.engine.base import (
    Layer,
    get_initializer,
)
from zoo_tpu_torch.pipeline.api.keras.engine.topology import Input, Model
from zoo_tpu_torch.pipeline.api.keras.layers import (
    GRU,
    LSTM,
    Dense,
    Lambda,
    SimpleRNN,
)
from zoo_tpu_torch.pipeline.api.keras.layers.recurrent import _Recurrent


def _create_rnn(rnn_type: str, nlayers: int, hidden_size: int):
    t = rnn_type.lower()
    cells = {"lstm": LSTM, "gru": GRU, "simplernn": SimpleRNN}
    if t not in cells:
        raise ValueError("Only support lstm|gru|simplernn")
    return [cells[t](hidden_size, return_sequences=True)
            for _ in range(nlayers)]


class RNNEncoder:
    """Stacked recurrent layers and an optional embedding; the core
    drives their cell steps."""

    def __init__(self, rnns: Sequence[_Recurrent], embedding=None,
                 input_shape=None):
        self.rnns = list(rnns)
        self.embedding = embedding
        self.input_shape = input_shape

    @classmethod
    def initialize(cls, rnn_type: str, nlayers: int, hidden_size: int,
                   embedding=None, input_shape=None):
        return cls(_create_rnn(rnn_type, nlayers, hidden_size),
                   embedding, input_shape)


class RNNDecoder(RNNEncoder):
    """The same structure; the core seeds its states from the bridge."""


class Bridge:
    """How the encoder's final states become the decoder's initial
    states: ``dense``/``densenonlinear`` concatenate every encoder state
    feature-wise, project to the decoder's total state size (tanh after
    it for ``densenonlinear``) and split; ``customized`` applies a keras
    layer. A ``Seq2seq`` with no bridge passes the states through."""

    def __init__(self, bridge_type: str, decoder_hidden_size: int,
                 bridge=None):
        t = bridge_type.lower()
        if t not in ("dense", "densenonlinear", "customized"):
            raise ValueError(
                "bridge_type must be dense|densenonlinear|customized")
        if t == "customized" and bridge is None:
            raise ValueError("customized bridge needs the keras layer")
        self.bridge_type = t
        self.decoder_hidden_size = decoder_hidden_size
        self.bridge = bridge

    @classmethod
    def initialize(cls, bridge_type: str, decoder_hidden_size: int):
        return cls(bridge_type, decoder_hidden_size, None)

    @classmethod
    def initialize_from_keras_layer(cls, bridge):
        return cls("customized", 0, bridge)


def _state_list(carry) -> List[torch.Tensor]:
    """One layer's carry (h or (h, c)) as a list."""
    return list(carry) if isinstance(carry, tuple) else [carry]


def _n_states(cell: _Recurrent) -> int:
    return 2 if isinstance(cell, LSTM) else 1


def _pack_state(n: int, flat: List):
    return tuple(flat[:n]) if n > 1 else flat[0]


def _run_layer(cell: _Recurrent, p, x: torch.Tensor, carry):
    """One recurrent layer over (B, T, D) from ``carry``: the outputs
    (B, T, H) and the final carry."""
    zx = torch.matmul(x, p["W"]) + p["b"]
    hs = []
    for z in torch.unbind(zx, dim=1):
        carry, h = cell._step(p, carry, z)
        hs.append(h)
    return torch.stack(hs, dim=1), carry


class _Seq2seqCore(Layer):
    """Encoder, bridge, decoder and generator as one layer over
    ``[enc_x, dec_x]``. In training the decoder reads ``dec_x`` (teacher
    forcing), unless ``train_self_feed``; otherwise ``dec_x[:, 0]`` is
    the start token and each later step reads the previous output, for
    ``dec_x.shape[1]`` steps."""

    def __init__(self, encoder: RNNEncoder, decoder: RNNDecoder,
                 bridge: Optional[Bridge], generator,
                 train_self_feed: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.encoder = encoder
        self.decoder = decoder
        self.bridge = bridge
        self.generator = generator
        self.train_self_feed = train_self_feed

    def build(self, generator, input_shape):
        enc_shape, dec_shape = input_shape
        params = {}
        feat = enc_shape[-1]
        if self.encoder.embedding is not None:
            params["enc_emb"] = self.encoder.embedding.build(generator,
                                                             enc_shape)
            feat = self.encoder.embedding.compute_output_shape(
                enc_shape)[-1]
        for i, cell in enumerate(self.encoder.rnns):
            params[f"enc_{i}"] = cell.build(generator, (None, None, feat))
            feat = cell.output_dim
        dfeat = dec_shape[-1]
        if self.decoder.embedding is not None:
            params["dec_emb"] = self.decoder.embedding.build(generator,
                                                             dec_shape)
            dfeat = self.decoder.embedding.compute_output_shape(
                dec_shape)[-1]
        for i, cell in enumerate(self.decoder.rnns):
            params[f"dec_{i}"] = cell.build(generator, (None, None, dfeat))
            dfeat = cell.output_dim
        if self.bridge is not None:
            enc_units = sum(_n_states(c) * c.output_dim
                            for c in self.encoder.rnns)
            dec_units = sum(_n_states(c) * c.output_dim
                            for c in self.decoder.rnns)
            if self.bridge.bridge_type == "customized":
                params["bridge"] = self.bridge.bridge.build(
                    generator, (None, enc_units))
            else:
                params["bridge"] = {
                    "w": get_initializer("glorot_uniform")(
                        generator, (enc_units, dec_units)),
                    "b": get_initializer("zero")(generator, (dec_units,))}
        if self.generator is not None:
            params["gen"] = self.generator.build(generator, (None, dfeat))
        return params

    def _run_encoder(self, params, x, training, rng):
        if self.encoder.embedding is not None:
            x = self.encoder.embedding.call(params["enc_emb"], x,
                                            training=training, rng=rng)
        finals = []
        for i, cell in enumerate(self.encoder.rnns):
            x, carry = _run_layer(cell, params[f"enc_{i}"], x,
                                  cell._init_carry(x.shape[0], x.device))
            finals.append(carry)
        return x, finals

    def _bridge_states(self, params, enc_finals, training, rng):
        if self.bridge is None:
            return enc_finals
        flat = torch.cat([s for c in enc_finals for s in _state_list(c)],
                         dim=-1)
        if self.bridge.bridge_type == "customized":
            out = self.bridge.bridge.call(params["bridge"], flat,
                                          training=training, rng=rng)
        else:
            out = flat @ params["bridge"]["w"] + params["bridge"]["b"]
            if self.bridge.bridge_type == "densenonlinear":
                out = torch.tanh(out)
        states, lo = [], 0
        for cell in self.decoder.rnns:
            n, d = _n_states(cell), cell.output_dim
            parts = [out[:, lo + j * d:lo + (j + 1) * d] for j in range(n)]
            lo += n * d
            states.append(_pack_state(n, parts))
        return states

    def _gen_step(self, params, h, training, rng):
        if self.generator is None:
            return h
        return self.generator.call(params["gen"], h, training=training,
                                   rng=rng)

    def _decode_teacher(self, params, dec_x, states, training, rng):
        x = dec_x
        if self.decoder.embedding is not None:
            x = self.decoder.embedding.call(params["dec_emb"], x,
                                            training=training, rng=rng)
        for i, cell in enumerate(self.decoder.rnns):
            x, _ = _run_layer(cell, params[f"dec_{i}"], x, states[i])
        b, t = x.shape[0], x.shape[1]
        out = self._gen_step(params, x.reshape(b * t, -1), training, rng)
        return out.reshape(b, t, -1)

    def _decode_greedy(self, params, start, n_steps, states, rng):
        if self.decoder.embedding is not None:
            raise NotImplementedError(
                "greedy decoding through a decoder embedding needs an "
                "argmax->id feedback rule; pass explicit decoder inputs "
                "(teacher mode) or decode int sequences externally")
        states, prev, outs = list(states), start, []
        for _ in range(n_steps):
            x = prev
            for i, cell in enumerate(self.decoder.rnns):
                p = params[f"dec_{i}"]
                states[i], x = cell._step(p, states[i], x @ p["W"] + p["b"])
            prev = self._gen_step(params, x, False, rng)
            outs.append(prev)
        return torch.stack(outs, dim=1)

    def call(self, params, inputs, *, training=False, rng=None):
        enc_x, dec_x = inputs
        _, enc_finals = self._run_encoder(params, enc_x, training, rng)
        states = self._bridge_states(params, enc_finals, training, rng)
        if (training and not self.train_self_feed) or \
                self.decoder.embedding is not None:
            # an id decoder cannot feed its raw outputs back: it decodes
            # whatever ids the caller gave, as in teacher mode
            return self._decode_teacher(params, dec_x, states, training,
                                        rng)
        return self._decode_greedy(params, dec_x[:, 0], dec_x.shape[1],
                                   states, rng)

    def compute_output_shape(self, input_shape):
        enc_shape, dec_shape = input_shape
        d = dec_shape[-1]
        if self.generator is not None:
            d = self.generator.compute_output_shape((None, d))[-1]
        elif self.decoder.rnns:
            d = self.decoder.rnns[-1].output_dim
        return (dec_shape[0], dec_shape[1], d)


class Seq2seq(Model):
    """``Seq2seq(encoder, decoder, input_shape, output_shape,
    bridge=None, generator=None)``: a two-input model ``[enc_seq,
    dec_seq]``, teacher forcing in ``fit`` and greedy self-feeding in
    ``predict`` (``dec_seq[:, 0]`` is the start token; the rest only
    sets the length).

    The simplified constructor ``Seq2seq(input_length=, input_dim=,
    target_length=, output_dim=, rnn_type=, hidden_size=, num_layers=)``
    builds a dense bridge and a ``Dense`` generator, feeds a zero start
    token and self-feeds for ``target_length`` steps in both modes."""

    def __init__(self, encoder=None, decoder=None, input_shape=None,
                 output_shape=None, bridge=None, generator=None, *,
                 input_length: Optional[int] = None,
                 input_dim: Optional[int] = None,
                 target_length: Optional[int] = None,
                 output_dim: Optional[int] = None,
                 rnn_type: str = "lstm", hidden_size: int = 64,
                 num_layers: int = 1, name: str = "seq2seq"):
        if input_length is not None:
            encoder = RNNEncoder.initialize(rnn_type, num_layers,
                                            hidden_size)
            decoder = RNNDecoder.initialize(rnn_type, num_layers,
                                            hidden_size)
            bridge = Bridge.initialize("dense", hidden_size)
            generator = Dense(output_dim)
            input_shape = (input_length, input_dim)
            output_shape = (target_length, output_dim)
            self._single_input = True
        else:
            if encoder is None or decoder is None:
                raise ValueError(
                    "Seq2seq needs (encoder, decoder, input_shape, "
                    "output_shape) or the simplified input_length= form")
            if input_shape is None or output_shape is None:
                raise TypeError(
                    "input_shape and output_shape cannot be None")
            self._single_input = False
        self.encoder, self.decoder = encoder, decoder
        self.bridge, self.generator = bridge, generator
        self._out_len = int(output_shape[0])
        self._out_dim = int(output_shape[-1])
        core = _Seq2seqCore(encoder, decoder, bridge, generator,
                            train_self_feed=self._single_input,
                            name=f"{name}_core")
        enc_in = Input(shape=tuple(input_shape), name=f"{name}_enc_in")
        if self._single_input:
            t, d = self._out_len, self._out_dim
            # the derived decoder input: a zero start token and the length
            dec_node = Lambda(
                lambda x: torch.zeros((x.shape[0], t, d), dtype=x.dtype,
                                      device=x.device),
                output_shape=(t, d))(enc_in)
            super().__init__(input=enc_in, output=core([enc_in, dec_node]),
                             name=name)
        else:
            dec_in = Input(shape=tuple(output_shape),
                           name=f"{name}_dec_in")
            super().__init__(input=[enc_in, dec_in],
                             output=core([enc_in, dec_in]), name=name)
        self._core = core

    def infer(self, input, start_sign, max_seq_len: int = 30,
              stop_sign=None, build_output=None, device=None):
        """Greedy-decode up to ``max_seq_len`` steps from
        ``start_sign``, trimmed on the host after the first output equal
        to ``stop_sign`` (a single sample only); returns ``[start;
        generated...]``. Runs on the current CUDA device unless
        ``device`` names another."""
        if self._single_input:
            raise ValueError(
                "infer(start_sign=, max_seq_len=) needs the two-input "
                "Seq2seq form (encoder, decoder, ...) — the simplified "
                "single-input constructor generates exactly "
                "target_length steps from its internal start token; "
                "call predict(x) instead")
        x = np.asarray(input)
        if x.ndim == 2:
            x = x[None]
        start = np.asarray(start_sign).reshape(1, 1, -1)
        start = np.repeat(start, x.shape[0], axis=0)
        dec = np.concatenate(
            [start, np.zeros((x.shape[0], max_seq_len - 1,
                              start.shape[-1]), start.dtype)], axis=1)
        out = np.asarray(self.predict([x, dec], batch_size=max(
            1, x.shape[0]), device=device))
        if callable(build_output):
            out = np.asarray(build_output(out))
        if stop_sign is not None:
            if out.shape[0] != 1:
                raise ValueError(
                    "stop_sign trimming is defined for a single sample "
                    "(the reference infer contract); decode batches "
                    "without stop_sign and trim per row yourself")
            stop = np.asarray(stop_sign).reshape(-1)
            for t in range(out.shape[1]):
                if np.allclose(out[0, t], stop, atol=1e-8):
                    out = out[:, :t + 1]
                    break
        return np.concatenate([start.astype(out.dtype), out], axis=1)
