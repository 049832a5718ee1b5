"""Mixture-of-Experts Llama (counterpart of
``zoo_tpu/models/llm/moe_llama.py``).

Every block's SwiGLU MLP becomes a top-k routed bank of experts
(:func:`zoo_tpu_torch.ops.moe.moe_ffn`); the attention half, RoPE, the
norms and the block loop are :class:`Llama`'s. A block's keys are the
attention half's and ``router`` (n_block, H, E), ``w_gate``, ``w_up``
(n_block, E, H, F) and ``w_down`` (n_block, E, F, H).

``call`` drops the router's load-balancing loss (the inference path,
and the Keras ``fit``'s, as in the JAX package); a training step that
should balance the load uses :meth:`MoELlama.call_with_aux` and adds the
aux term to its loss. Capacity-factor dropping is the JAX package's
(GShard), not Mixtral's dropless routing.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from zoo_tpu_torch.models.llm.llama import (
    ATTN_KEYS,
    Llama,
    LlamaConfig,
    _glorot,
    rms_norm,
)
from zoo_tpu_torch.ops.moe import moe_ffn

__all__ = ["MoELlama", "place_moe_params"]

MOE_KEYS = ("router", "w_gate", "w_up", "w_down")


def _glorot_bank(shape, generator: torch.Generator) -> torch.Tensor:
    """Glorot-uniform for a stacked (n_block, E, in, out) expert bank
    with ``jax.nn.initializers.glorot_uniform``'s fans for each block's
    (E, in, out) draw: E counts in the receptive field, so the fans are
    E*in and E*out."""
    e = shape[-3]
    lim = math.sqrt(6.0 / (e * (shape[-2] + shape[-1])))
    return torch.empty(shape, dtype=torch.float32,
                       device=generator.device).uniform_(
        -lim, lim, generator=generator)


class MoELlama(Llama):
    """:class:`Llama` with a routed expert bank in every block:
    ``n_experts`` experts, ``top_k`` taken a token, ``capacity_factor``
    slots per expert and routing group, ``aux_loss_weight`` on the
    balancing term."""

    block_keys = ATTN_KEYS + MOE_KEYS

    def __init__(self, config: Optional[LlamaConfig] = None,
                 params: Optional[Dict] = None, *, n_experts: int = 8,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 aux_loss_weight: float = 0.01, **kwargs):
        super().__init__(config, params, **kwargs)
        self.n_experts = int(n_experts)
        self.top_k = int(top_k)
        self.capacity_factor = float(capacity_factor)
        self.aux_loss_weight = float(aux_loss_weight)

    # -- params -----------------------------------------------------------
    def _mlp_block_params(self, config: LlamaConfig,
                          generator: torch.Generator) -> Dict:
        c, g, L, E = config, generator, config.n_block, self.n_experts
        return {"router": _glorot((L, c.hidden, E), g),
                "w_gate": _glorot_bank((L, E, c.hidden, c.intermediate), g),
                "w_up": _glorot_bank((L, E, c.hidden, c.intermediate), g),
                "w_down": _glorot_bank((L, E, c.intermediate, c.hidden), g)}

    # -- forward ----------------------------------------------------------
    def _moe_part(self, p, h):
        x = rms_norm(h, p["mlp_norm"], self.cfg.rms_eps)
        y, aux = moe_ffn({k: p[k] for k in MOE_KEYS}, x, top_k=self.top_k,
                         capacity_factor=self.capacity_factor,
                         aux_loss_weight=self.aux_loss_weight)
        return h + y, aux

    def _mlp_part(self, p, h):
        return self._moe_part(p, h)[0]   # the inference path drops aux

    def call_with_aux(self, params: Dict, ids: torch.Tensor):
        """``(logits, aux)``: the training forward with the summed
        load-balancing loss of every block (a 0-dim f32 tensor), to add
        to the task loss."""
        h, cos, sin, impl = self._embed(params, ids)
        # remat "dots" checkpoints the MoE half only, keeping its mm
        # outputs; True checkpoints the whole block, as Llama.call
        block = self._block_fn(self._moe_part)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for p in self._per_block(params):
            h, a = block(p, h, cos, sin, impl)
            aux = aux + a
        return self._head(params, h), aux


def place_moe_params(params, mesh):
    raise NotImplementedError(
        "place_moe_params: expert-parallel placement over a mesh is not "
        "ported to zoo_tpu_torch yet (ROADMAP A.14)")
