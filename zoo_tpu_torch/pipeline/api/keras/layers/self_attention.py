"""Transformer and BERT layers, keras-1 style (counterpart of
``zoo_tpu/pipeline/api/keras/layers/self_attention.py``).

Each is one layer owning the whole stack: embeddings and ``n_block``
post-LN blocks whose weights stay stacked ``(n_block, ...)``, the JAX
package's layout, so its trees load by name. The blocks run by a loop
over slices of the stacked tensors where the JAX package scans. The
attention goes through :func:`~zoo_tpu_torch.ops.attention.dot_product_attention`
(the flash kernels from 512 tokens on the card under ``auto``, the
dense path below that or with a mask).

Dropout in training follows the JAX package's key chain: the layer's
key ``layer_rng(rng, name)``, split once per block, then within a block
one split for each site whose rate is above 0, in the order attention
probabilities, hidden after the projection, hidden after the MLP. The
masks are JAX's for those keys (the dropout kernel on the card), and
with attention dropout ``auto`` takes the dense attention, as JAX's
does. Under ``remat`` the recomputed forward draws the same masks from
the same keys. An inference forward applies none, in either package.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from zoo_tpu_torch.models.llm.llama import (
    _dots_context,
    resolve_attention_impl,
)
from zoo_tpu_torch.ops.attention import (
    dot_product_attention,
    merge_heads,
    split_heads,
)
from zoo_tpu_torch.pipeline.api.keras.engine.base import (
    Layer,
    get_activation_fn,
    layer_rng,
    normal,
)
from zoo_tpu_torch.pipeline.api.keras.layers.core import take_rows


def _layer_norm(x, gamma, beta, eps=1e-5):
    """Mean and population variance in f32; the normalized tensor is cast
    to ``x``'s dtype before the affine, the JAX package's rounding
    point."""
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=-1, keepdim=True, correction=0)
    out = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return out * gamma.to(x.dtype) + beta.to(x.dtype)


class LayerNorm(Layer):
    """Layer normalization over the last axis, ``gamma`` and ``beta``."""

    def __init__(self, epsilon: float = 1e-5, **kwargs):
        super().__init__(**kwargs)
        self.epsilon = epsilon

    def build(self, generator, input_shape):
        d = input_shape[-1]
        dev = generator.device
        return {"gamma": torch.ones((d,), device=dev),
                "beta": torch.zeros((d,), device=dev)}

    def call(self, params, inputs, *, training=False, rng=None):
        return _layer_norm(inputs, params["gamma"], params["beta"],
                           self.epsilon)


def _block_params(generator, n_block: int, hidden: int, intermediate: int,
                  init) -> Dict:
    """The ``n_block`` blocks' weights, stacked: matrices from ``init``,
    zero biases, unit norm gains."""
    dev = generator.device

    def zeros(*shape):
        return torch.zeros((n_block,) + shape, device=dev)

    def ones(*shape):
        return torch.ones((n_block,) + shape, device=dev)

    return {
        "qkv_w": init(generator, (n_block, hidden, 3 * hidden)),
        "qkv_b": zeros(3 * hidden),
        "proj_w": init(generator, (n_block, hidden, hidden)),
        "proj_b": zeros(hidden),
        "ln1_g": ones(hidden),
        "ln1_b": zeros(hidden),
        "fc1_w": init(generator, (n_block, hidden, intermediate)),
        "fc1_b": zeros(intermediate),
        "fc2_w": init(generator, (n_block, intermediate, hidden)),
        "fc2_b": zeros(hidden),
        "ln2_g": ones(hidden),
        "ln2_b": zeros(hidden),
    }


def _drop(x, key, p):
    """Hidden dropout of rate ``p`` with JAX's mask for ``key`` (None:
    the identity)."""
    if key is None:
        return x
    from zoo_tpu_torch.ops.kernels import dropout as D
    return D.dropout(x, key, p)


def _attention_half(p, h, *, n_head, mask, causal, impl, drop=None):
    """Self-attention, the output projection and the residual, then the
    first norm. ``drop``: ``(attn_p, attn_key, hidden_p, hidden_key)``
    in training with dropout (a None key skips its site)."""
    q, k, v = torch.split(h @ p["qkv_w"] + p["qkv_b"], h.shape[-1], dim=-1)
    attn_p, attn_key, hidden_p, hidden_key = drop or (0.0, None, 0.0, None)
    # the kernels read rows of head_dim contiguous elements; dropout
    # keywords only where a site draws
    extra = {} if attn_key is None else dict(dropout_p=attn_p,
                                             dropout_rng=attn_key)
    a = dot_product_attention(
        split_heads(q, n_head).contiguous(),
        split_heads(k, n_head).contiguous(),
        split_heads(v, n_head).contiguous(), mask=mask, causal=causal,
        impl=impl, **extra)
    a = _drop(merge_heads(a) @ p["proj_w"] + p["proj_b"], hidden_key,
              hidden_p)
    return _layer_norm(h + a, p["ln1_g"], p["ln1_b"])


def _mlp_half(p, h, act, hidden_p=0.0, hidden_key=None):
    f = act(h @ p["fc1_w"] + p["fc1_b"]) @ p["fc2_w"] + p["fc2_b"]
    f = _drop(f, hidden_key, hidden_p)
    return _layer_norm(h + f, p["ln2_g"], p["ln2_b"])


def _block_forward(p, h, *, n_head, mask, causal, act, impl, keys=None,
                   rates=(0.0, 0.0)):
    """Post-LN transformer block (GPT-1 / BERT style). ``keys``: the
    block's ``(attention, hidden, mlp)`` dropout keys (None: no
    dropout), ``rates``: ``(attn_drop, hidden_drop)``."""
    keys = keys or (None, None, None)
    h = _attention_half(p, h, n_head=n_head, mask=mask, causal=causal,
                        impl=impl, drop=(rates[0], keys[0], rates[1],
                                         keys[1]))
    return _mlp_half(p, h, act, rates[1], keys[2])


class TransformerLayer(Layer):
    """GPT-style stack: token and learned position embeddings, then
    ``n_block`` blocks, causal unless ``bidirectional``. Input: int ids
    (B, T); output (B, T, hidden_size).

    ``remat`` sets what the backward recomputes, as the port's
    :class:`~zoo_tpu_torch.models.llm.llama.Llama` does: ``False`` keeps
    every activation; ``True`` checkpoints whole blocks (attention
    included); ``"dots"`` checkpoints the MLP half and keeps its matrix
    products, recomputing the norm and the gelu chain (the JAX
    package's ``dots_with_no_batch_dims_saveable``), while the attention
    half keeps the flash kernel's residuals."""

    def __init__(self, vocab: int, seq_len: int, n_block: int = 12,
                 hidden_size: int = 768, n_head: int = 12,
                 intermediate_size: Optional[int] = None,
                 hidden_drop: float = 0.1, attn_drop: float = 0.1,
                 initializer_range: float = 0.02,
                 bidirectional: bool = False, activation="gelu",
                 attention_impl: str = "auto", remat=False, **kwargs):
        super().__init__(**kwargs)
        if hidden_size % n_head:
            raise ValueError("hidden_size must divide by n_head")
        if attention_impl == "flash" and attn_drop > 0:
            raise ValueError(
                "attention_impl='flash' does not support attention dropout; "
                "pass attn_drop=0")
        if remat not in (False, True, "dots"):
            raise ValueError(f"remat must be False, True or 'dots', "
                             f"got {remat!r}")
        self.attention_impl = attention_impl
        self.remat = remat
        self.vocab = vocab
        self.seq_len = seq_len
        self.n_block = n_block
        self.hidden_size = hidden_size
        self.n_head = n_head
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.hidden_drop = hidden_drop
        self.attn_drop = attn_drop
        self.bidirectional = bidirectional
        self.act = get_activation_fn(activation)
        self._init = normal(initializer_range)
        self.last_attention_impl: Optional[str] = None

    def build(self, generator, input_shape):
        return {
            "tok": self._init(generator, (self.vocab, self.hidden_size)),
            "pos": self._init(generator, (self.seq_len, self.hidden_size)),
            "blocks": _block_params(generator, self.n_block,
                                    self.hidden_size,
                                    self.intermediate_size, self._init),
        }

    def _embed(self, params, ids):
        return take_rows(params["tok"], ids) + params["pos"][:ids.shape[1]]

    def _block_fn(self, training: bool):
        """The per-block function under this layer's ``remat`` (which
        only matters in training while autograd records)."""
        block = functools.partial(_block_forward, n_head=self.n_head,
                                  causal=not self.bidirectional,
                                  act=self.act,
                                  rates=(self.attn_drop, self.hidden_drop))
        if not (training and torch.is_grad_enabled()) or \
                self.remat is False:
            return block
        if self.remat == "dots":
            def dots_block(p, h, *, mask, impl, keys=None):
                keys = keys or (None, None, None)
                h = _attention_half(p, h, n_head=self.n_head, mask=mask,
                                    causal=not self.bidirectional,
                                    impl=impl,
                                    drop=(self.attn_drop, keys[0],
                                          self.hidden_drop, keys[1]))
                return checkpoint(_mlp_half, p, h, self.act,
                                  self.hidden_drop, keys[2],
                                  use_reentrant=False,
                                  context_fn=_dots_context)
            return dots_block
        return functools.partial(checkpoint, block, use_reentrant=False)

    def _block_keys(self, rng, training: bool) -> list:
        """Each block's ``(attention, hidden, mlp)`` dropout keys, the
        JAX package's chain: ``layer_rng``, one split per block, then one
        split per site whose rate is above 0 (a None where a site draws
        nothing); ``[None] * n_block`` outside training or without an
        ``rng``."""
        if not training or rng is None or \
                (self.attn_drop <= 0 and self.hidden_drop <= 0):
            return [None] * self.n_block
        from zoo_tpu_torch.ops.kernels import dropout as D
        rng = layer_rng(rng, self.name)
        out = []
        for _ in range(self.n_block):
            rng, brng = D.split(rng)
            sites = []
            for rate in (self.attn_drop, self.hidden_drop, self.hidden_drop):
                key = None
                if rate > 0:
                    brng, key = D.split(brng)
                sites.append(key)
            out.append(tuple(sites))
        return out

    def _run_blocks(self, params, h, mask, training, rng=None):
        impl = self.attention_impl
        if impl == "auto":
            # attention dropout takes the dense path, as JAX's auto does
            flash_ok = mask is None and not (training and
                                             self.attn_drop > 0)
            impl = resolve_attention_impl("auto", h.shape[1], h.device) \
                if flash_ok else "dense"
        self.last_attention_impl = impl
        # one unbind per stacked leaf: its backward stacks the per-block
        # gradients once
        per_key = {k: torch.unbind(w, 0) for k, w in params["blocks"].items()}
        block = self._block_fn(training)
        keys = self._block_keys(rng, training)
        for i in range(self.n_block):
            extra = {} if keys[i] is None else {"keys": keys[i]}
            h = block({k: w[i] for k, w in per_key.items()}, h, mask=mask,
                      impl=impl, **extra)
        return h

    def call(self, params, inputs, *, training=False, rng=None):
        return self._run_blocks(params, self._embed(params, inputs), None,
                                training, rng)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape) + (self.hidden_size,)


class BERT(TransformerLayer):
    """BERT encoder: token, position and segment embeddings with the
    embedding LayerNorm, bidirectional blocks, and a tanh pooler over
    [CLS] (:meth:`pooled_output`). Inputs: ``ids`` or ``[ids,
    token_type_ids, attention_mask]`` (the mask, 1 = attend, becomes a
    (B, 1, 1, T) bool mask and takes the dense attention). ``call``
    returns the sequence output."""

    def __init__(self, vocab: int, hidden_size: int = 768, n_block: int = 12,
                 n_head: int = 12, seq_len: int = 512,
                 intermediate_size: int = 3072, hidden_p_drop: float = 0.1,
                 attn_p_drop: float = 0.1, max_position_len: int = 512,
                 token_type_vocab: int = 2, initializer_range: float = 0.02,
                 **kwargs):
        super().__init__(vocab=vocab, seq_len=max(seq_len, max_position_len),
                         n_block=n_block, hidden_size=hidden_size,
                         n_head=n_head, intermediate_size=intermediate_size,
                         hidden_drop=hidden_p_drop, attn_drop=attn_p_drop,
                         initializer_range=initializer_range,
                         bidirectional=True, activation="gelu", **kwargs)
        self.token_type_vocab = token_type_vocab

    def build(self, generator, input_shape):
        base = super().build(generator, input_shape)
        h, dev = self.hidden_size, generator.device
        base["seg"] = self._init(generator, (self.token_type_vocab, h))
        base["emb_ln_g"] = torch.ones((h,), device=dev)
        base["emb_ln_b"] = torch.zeros((h,), device=dev)
        base["pool_w"] = self._init(generator, (h, h))
        base["pool_b"] = torch.zeros((h,), device=dev)
        return base

    @staticmethod
    def _split_inputs(inputs):
        if isinstance(inputs, (list, tuple)):
            ids = inputs[0]
            seg = inputs[1] if len(inputs) > 1 else None
            mask = inputs[2] if len(inputs) > 2 else None
            return ids, seg, mask
        return inputs, None, None

    def call(self, params, inputs, *, training=False, rng=None):
        ids, seg, attn_mask = self._split_inputs(inputs)
        h = self._embed(params, ids)
        if seg is not None:
            h = h + take_rows(params["seg"], seg)
        h = _layer_norm(h, params["emb_ln_g"], params["emb_ln_b"])
        mask = None
        if attn_mask is not None:
            mask = attn_mask[:, None, None, :].bool()
        return self._run_blocks(params, h, mask, training, rng)

    def pooled_output(self, params, sequence_output):
        """The [CLS] tanh pooler (the reference BERT's second output)."""
        return torch.tanh(sequence_output[:, 0] @ params["pool_w"]
                          + params["pool_b"])

    def compute_output_shape(self, input_shape):
        shape = input_shape[0] if isinstance(input_shape, list) else \
            input_shape
        return tuple(shape) + (self.hidden_size,)
