"""Llama-family decoder-only LM (counterpart of
``zoo_tpu/models/llm/llama.py``).

RMSNorm pre-norm, rotary position embeddings in rotate-half form,
grouped-query attention, SwiGLU MLP, no biases. Parameters keep the JAX
package's layout so the two hold the same numbers for the same model:
``(in, out)`` matrices (``x @ w``) and per-block weights stacked on a
leading ``n_block`` axis — ``embed``, ``blocks/{wq, wk, wv, wo,
attn_norm, mlp_norm, w_gate, w_up, w_down}``, ``final_norm``, ``head``
(:func:`zoo_tpu_torch.convert.params_from_jax` reads that tree).

One :class:`Llama` serves and trains: ``Llama(config, params)`` holds a
parameter tree as trainable ``nn.Parameter`` objects (the serving path), and
``Llama(config, input_shape=(T,), remat=...)`` is a Keras layer whose
parameters the model holds (``Sequential.add``).
"""

from __future__ import annotations

import math
import functools
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn
import torch.nn.functional as F

from zoo_tpu_torch.common.device import resolve_device
from zoo_tpu_torch.common.knobs import value as knob_value
from zoo_tpu_torch.ops.attention import dot_product_attention
from zoo_tpu_torch.pipeline.api.keras.engine.base import Layer

BLOCK_KEYS = ("wq", "wk", "wv", "wo", "attn_norm", "mlp_norm", "w_gate",
              "w_up", "w_down")


@dataclass(frozen=True)
class LlamaConfig:
    vocab: int = 32000
    hidden: int = 4096
    n_block: int = 32
    n_head: int = 32
    n_kv_head: int = 8
    intermediate: int = 14336
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden // self.n_head


def llama3_8b_config() -> LlamaConfig:
    """Llama-3-8B shapes (public architecture card)."""
    return LlamaConfig(vocab=128256, hidden=4096, n_block=32, n_head=32,
                       n_kv_head=8, intermediate=14336,
                       rope_theta=500000.0)


def tiny_llama_config(vocab: int = 256) -> LlamaConfig:
    """Test/dryrun config: same topology, toy widths."""
    return LlamaConfig(vocab=vocab, hidden=64, n_block=2, n_head=4,
                       n_kv_head=2, intermediate=128, rope_theta=10000.0)


def llama_param_count(cfg: LlamaConfig) -> int:
    """Analytic parameter count (embed + blocks + final norm + lm head)."""
    h, kv = cfg.hidden, cfg.n_kv_head * cfg.head_dim
    per_block = (h * h + 2 * h * kv + h * h
                 + 3 * h * cfg.intermediate
                 + 2 * h)
    total = cfg.vocab * h + cfg.n_block * per_block + h
    if not cfg.tie_embeddings:
        total += cfg.vocab * h
    return total


def resolve_attention_impl(impl: str, seq_len: int, device=None) -> str:
    """Concrete attention for an ``attention_impl`` request at
    ``seq_len`` on ``device``: ``"auto"`` picks the flash kernel from
    ``ZOO_LLAMA_FLASH_MIN_SEQ`` tokens up (default 512, the threshold the
    JAX package uses) on a CUDA device, else the dense path.
    ``ZOO_LLAMA_ATTN_IMPL`` force-overrides auto; ``"dense"``/``"flash"``
    pass through."""
    if impl != "auto":
        return impl
    forced = knob_value("ZOO_LLAMA_ATTN_IMPL")
    if forced:
        return forced
    from zoo_tpu_torch.ops.kernels import on_cuda
    min_seq = int(knob_value("ZOO_LLAMA_FLASH_MIN_SEQ"))
    return "flash" if seq_len >= min_seq and on_cuda(device) else "dense"


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float):
    """f32 island for the moment and rsqrt; the normalised tensor drops
    back to ``x``'s dtype before the gain multiply (as the JAX
    ``_rms_norm``)."""
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * inv).to(x.dtype) * gain.to(x.dtype)


def rope_frequencies(head_dim: int, seq_len: int, theta: float,
                     device=None):
    """(T, D/2) cos/sin tables, f32."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    ang = torch.outer(t, inv)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate (B, H, T, D) by per-position angles (rotate-half)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos[None, None].to(x.dtype)
    s = sin[None, None].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _glorot(shape, generator: torch.Generator) -> torch.Tensor:
    """Glorot-uniform over the last two axes (fans ``shape[-2]``,
    ``shape[-1]``), as ``jax.nn.initializers.glorot_uniform`` on each
    block's (in, out) matrix."""
    lim = math.sqrt(6.0 / (shape[-2] + shape[-1]))
    return torch.empty(shape, dtype=torch.float32,
                       device=generator.device).uniform_(
        -lim, lim, generator=generator)


def init_params(config: LlamaConfig, generator: torch.Generator,
                lm_head: bool = True) -> Dict:
    """A parameter tree drawn from ``generator`` on its device:
    glorot-uniform matrices with the JAX package's fans, unit norm gains,
    and the embedding scaled by 0.02 * sqrt(3). The draws differ from
    ``jax.random``'s: to hold the same weights as a JAX model, convert
    its params instead."""
    c, g, dev = config, generator, generator.device
    kv = c.n_kv_head * c.head_dim
    L = c.n_block
    params = {"embed": _glorot((c.vocab, c.hidden), g)
              * (0.02 * math.sqrt(3.0))}
    blocks = {
        "wq": _glorot((L, c.hidden, c.hidden), g),
        "wk": _glorot((L, c.hidden, kv), g),
        "wv": _glorot((L, c.hidden, kv), g),
        "wo": _glorot((L, c.hidden, c.hidden), g),
        "w_gate": _glorot((L, c.hidden, c.intermediate), g),
        "w_up": _glorot((L, c.hidden, c.intermediate), g),
        "w_down": _glorot((L, c.intermediate, c.hidden), g),
    }
    for k in ("attn_norm", "mlp_norm"):
        blocks[k] = torch.ones((L, c.hidden), device=dev)
    params["blocks"] = blocks
    params["final_norm"] = torch.ones((c.hidden,), device=dev)
    if lm_head and not c.tie_embeddings:
        params["head"] = _glorot((c.hidden, c.vocab), g)
    return params


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the outputs
    of matrix products without batch dimensions (``aten.mm``, what ``x @
    w`` lowers to), recompute the elementwise chains — the JAX package's
    ``dots_with_no_batch_dims_saveable``."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(_save_dots)


class Llama(Layer):
    """Decoder-only Llama LM: int ids (B, T) -> logits (B, T, vocab)
    (``lm_head=True``) or hidden states (B, T, hidden).

    ``Llama(config, params)`` wraps a parameter tree (without copying
    it) as trainable parameters; ``Llama.from_seed(config, seed=...)``
    draws one from a seed. Without ``params`` it is a Keras layer
    (``input_shape=(T,)``) whose ``build(generator, input_shape)``
    returns a tree for the model to hold and whose ``call(params, ids,
    training=...)`` runs on the tree it is given.

    ``remat`` sets what the backward pass recomputes, as in the JAX
    package: ``False`` keeps every block activation; ``True`` checkpoints
    whole blocks (the backward reruns each block's forward, attention
    included); ``"dots"`` checkpoints only the MLP half and keeps its
    matrix products, recomputing the norm and the SwiGLU elementwise
    chain — the attention half keeps the flash kernel's residuals."""

    def __init__(self, config: Optional[LlamaConfig] = None,
                 params: Optional[Dict] = None, *, lm_head: bool = True,
                 attention_impl: str = "auto", remat=False,
                 input_shape=None, name: Optional[str] = None):
        super().__init__(input_shape=input_shape, name=name)
        config = config or LlamaConfig()
        self.cfg = config
        if config.hidden % config.n_head:
            raise ValueError("hidden must divide by n_head")
        if config.n_head % config.n_kv_head:
            raise ValueError("n_head must divide by n_kv_head")
        if remat not in (False, True, "dots"):
            raise ValueError(
                f"remat must be False, True or 'dots', got {remat!r}")
        self.lm_head = lm_head
        self.attention_impl = attention_impl
        self.remat = remat
        self.last_attention_impl: Optional[str] = None
        self.embed = self.blocks = self.final_norm = self.head = None
        if params is not None:
            self.embed = nn.Parameter(params["embed"])
            self.blocks = nn.ParameterDict(
                {k: nn.Parameter(params["blocks"][k]) for k in BLOCK_KEYS})
            self.final_norm = nn.Parameter(params["final_norm"])
            if lm_head and not config.tie_embeddings:
                self.head = nn.Parameter(params["head"])

    @classmethod
    def from_seed(cls, config: LlamaConfig, *, seed: int = 0, device=None,
                  lm_head: bool = True, attention_impl: str = "auto"
                  ) -> "Llama":
        """A model whose weights come from a ``torch.Generator`` seeded
        with ``seed`` on ``device`` (see :func:`init_params`)."""
        dev = resolve_device(device)
        g = torch.Generator(device=dev).manual_seed(int(seed))
        return cls(config, init_params(config, g, lm_head), lm_head=lm_head,
                   attention_impl=attention_impl)

    def build(self, generator: torch.Generator, input_shape) -> Dict:
        return init_params(self.cfg, generator, self.lm_head)

    @property
    def params(self) -> Dict:
        """The parameter tree in the JAX package's layout (the module's
        own tensors, not copies)."""
        if self.embed is None:
            raise ValueError("this Llama is a Keras layer: its params are "
                             "held by the model")
        out = {"embed": self.embed, "blocks": dict(self.blocks),
               "final_norm": self.final_norm}
        if self.head is not None:
            out["head"] = self.head
        return out

    def compute_output_shape(self, input_shape):
        b, t = input_shape
        return (b, t, self.cfg.vocab if self.lm_head else self.cfg.hidden)

    def _attn_part(self, p, h, cos, sin, impl):
        c = self.cfg
        B, T, _ = h.shape
        x = rms_norm(h, p["attn_norm"], c.rms_eps)
        q = (x @ p["wq"]).reshape(B, T, c.n_head, c.head_dim)
        k = (x @ p["wk"]).reshape(B, T, c.n_kv_head, c.head_dim)
        v = (x @ p["wv"]).reshape(B, T, c.n_kv_head, c.head_dim)
        q = apply_rope(q.transpose(1, 2), cos, sin).contiguous()
        k = apply_rope(k.transpose(1, 2), cos, sin).contiguous()
        v = v.transpose(1, 2).contiguous()
        a = dot_product_attention(q, k, v, causal=True, impl=impl)
        a = a.transpose(1, 2).reshape(B, T, c.hidden)
        return h + a @ p["wo"]

    def _mlp_part(self, p, h):
        x = rms_norm(h, p["mlp_norm"], self.cfg.rms_eps)
        return h + (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]

    def _block(self, p, h, cos, sin, impl):
        return self._mlp_part(p, self._attn_part(p, h, cos, sin, impl))

    def _block_fn(self):
        """The per-block function under this layer's ``remat`` (which
        only matters while autograd records)."""
        from torch.utils.checkpoint import checkpoint
        if not torch.is_grad_enabled() or self.remat is False:
            return self._block
        if self.remat == "dots":
            def block(p, h, cos, sin, impl):
                h = self._attn_part(p, h, cos, sin, impl)
                return checkpoint(self._mlp_part, p, h, use_reentrant=False,
                                  context_fn=_dots_context)
            return block
        return functools.partial(checkpoint, self._block,
                                 use_reentrant=False)

    def call(self, params: Dict, ids: torch.Tensor, *,
             training: bool = False) -> torch.Tensor:
        c = self.cfg
        h = params["embed"][ids.long()]
        T = ids.shape[1]
        cos, sin = rope_frequencies(c.head_dim, T, c.rope_theta, h.device)
        impl = resolve_attention_impl(self.attention_impl, T, h.device)
        self.last_attention_impl = impl
        # one unbind per stacked leaf: its backward stacks the per-block
        # gradients once, where w[i] per block would materialise a
        # zero-filled gradient of the whole stack for every block
        per_key = [torch.unbind(params["blocks"][k], 0) for k in BLOCK_KEYS]
        block = self._block_fn()
        for ws in zip(*per_key):
            h = block(dict(zip(BLOCK_KEYS, ws)), h, cos, sin, impl)
        h = rms_norm(h, params["final_norm"], c.rms_eps)
        if not self.lm_head:
            return h
        head = params["embed"].T if c.tie_embeddings else params["head"]
        return h @ head.to(h.dtype)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.call(self.params, ids)
