"""Mixture-of-Experts feed-forward (counterpart of ``zoo_tpu/ops/moe.py``).

GShard's grouped dense dispatch, as the JAX package computes it: tokens
are routed top-k within fixed groups of ``group_size``, each expert
takes at most ``C`` tokens a group (capacity-factor dropping keeps every
shape static), and the dispatch and combine are one-hot products. The
expert banks carry a leading ``E`` axis: ``router`` (H, E), ``w_gate``
and ``w_up`` (E, H, F), ``w_down`` (E, F, H).

The products with a batch axis (the dispatch over groups, the expert
products over experts, the combine) are ``torch.bmm``, so the Llama
layer's ``remat="dots"`` policy, which keeps only ``aten.mm`` outputs,
recomputes them in the backward, as JAX's
``dots_with_no_batch_dims_saveable`` does; the router's product is an
``mm`` and is kept.

Expert parallelism over a mesh (``moe_param_specs``) is ROADMAP A.14.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["init_moe_params", "moe_ffn", "moe_param_specs",
           "expert_capacity"]


def expert_capacity(n_tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Per-expert token slots a group, a multiple of 8 (at least 8)."""
    cap = int(math.ceil(top_k * n_tokens * capacity_factor / n_experts))
    return max(8, -(-cap // 8) * 8)


def init_moe_params(generator: torch.Generator, hidden: int,
                    intermediate: int, n_experts: int,
                    init=None) -> Dict[str, torch.Tensor]:
    """The router and the three expert banks, drawn from ``generator``
    on its device with ``init`` (default glorot-uniform with JAX's fans:
    an (E, H, F) bank counts E in its receptive field, so its fans are
    E*H and E*F). The draws differ from ``jax.random``'s; to hold a JAX
    model's weights, convert them."""
    if init is None:
        from zoo_tpu_torch.pipeline.api.keras.engine.base import (
            get_initializer,
        )
        init = get_initializer("glorot_uniform")
    E, H, Fd = n_experts, hidden, intermediate
    return {"router": init(generator, (H, E)),
            "w_gate": init(generator, (E, H, Fd)),
            "w_up": init(generator, (E, H, Fd)),
            "w_down": init(generator, (E, Fd, H))}


def moe_param_specs(n_experts: int):
    raise NotImplementedError(
        "moe_param_specs: expert sharding over a mesh is not ported to "
        "zoo_tpu_torch yet (ROADMAP A.14)")


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax``: max subtracted, exp, divided by the sum."""
    u = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return u / u.sum(dim=-1, keepdim=True)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, the lower
    index first among equals (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot(idx, n)`` in f32 by comparison: an index outside
    [0, n) gives a row of zeros (``F.one_hot`` would raise)."""
    return (idx.unsqueeze(-1) == torch.arange(n, device=idx.device)
            ).to(torch.float32)


def moe_ffn(params: Dict, x: torch.Tensor, *, top_k: int = 2,
            capacity_factor: Optional[float] = None,
            aux_loss_weight: float = 0.01, group_size: int = 512
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE SwiGLU feed-forward over ``x`` (B, T, H): returns ``(y,
    aux_loss)``, ``aux_loss`` the weighted Switch load-balancing term (a
    0-dim f32 tensor). Tokens past an expert's capacity in their group
    are dropped (their rows of ``y`` are zero; the residual carries
    them). ``capacity_factor=None`` reads ``ZOO_MOE_CAPACITY``.

    The router runs in f32 on ``x`` in f32; the dispatch, the expert
    products and the combine run in ``x``'s dtype with the weights and
    the combine weights cast to it, as in the JAX package."""
    if capacity_factor is None:
        from zoo_tpu_torch.common.knobs import value
        capacity_factor = float(value("ZOO_MOE_CAPACITY"))
    B, T, H = x.shape
    E = params["router"].shape[1]
    N = B * T
    G = min(int(group_size), N)
    n_groups = -(-N // G)
    pad = n_groups * G - N
    xf = x.reshape(N, H)
    if pad:
        xf = torch.cat([xf, xf.new_zeros((pad, H))], dim=0)
    xg = xf.reshape(n_groups, G, H)
    # padded rows claim no capacity and stay out of the aux loss
    valid = (torch.arange(n_groups * G, device=x.device) < N).to(
        torch.float32).reshape(n_groups, G)
    C = expert_capacity(G, E, top_k, capacity_factor)

    logits = (xg.reshape(-1, H).float() @ params["router"].float()
              ).reshape(n_groups, G, E)
    probs = _softmax(logits)                                # (g, G, E)
    gate_vals, gate_idx = _top_k(probs, top_k)              # (g, G, k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    gate_vals = gate_vals * valid[..., None]

    # each (token, choice)'s place in its expert's queue: slot-major,
    # so every first choice claims capacity before any second choice
    with torch.no_grad():
        oh = _one_hot(gate_idx, E) * valid[..., None, None]  # (g, G, k, E)
        flat = oh.transpose(1, 2).reshape(n_groups, top_k * G, E)
        pos = (torch.cumsum(flat, dim=1) - 1.0) * flat
        pos = pos.reshape(n_groups, top_k, G, E).transpose(1, 2)
        keep = (pos < C) & (oh > 0)                          # (g, G, k, E)
        slot = _one_hot(pos.to(torch.int64), C) * keep[..., None]
    combine = (slot * gate_vals[..., None, None]).sum(2)     # (g, G, E, C)
    dispatch = (combine > 0).to(x.dtype)

    dt = x.dtype
    # (g, E*C, G) @ (g, G, H): every expert's slots of each group
    expert_in = torch.bmm(
        dispatch.reshape(n_groups, G, E * C).transpose(1, 2), xg)
    expert_in = expert_in.reshape(n_groups, E, C, H).transpose(0, 1) \
        .reshape(E, n_groups * C, H)
    a = F.silu(torch.bmm(expert_in, params["w_gate"].to(dt)))
    b = torch.bmm(expert_in, params["w_up"].to(dt))
    out_e = torch.bmm(a * b, params["w_down"].to(dt))        # (E, g*C, H)
    out_e = out_e.reshape(E, n_groups, C, H).transpose(0, 1) \
        .reshape(n_groups, E * C, H)
    y = torch.bmm(combine.to(dt).reshape(n_groups, G, E * C), out_e)
    y = y.reshape(n_groups * G, H)[:N]

    # Switch load balance: E * sum_e f_e * P_e over the valid tokens (f:
    # the share routed top-1 to e, P: the mean router probability)
    top1 = _one_hot(gate_idx[..., 0], E) * valid[..., None]
    denom = torch.clamp(valid.sum(), min=1.0)
    f = top1.sum((0, 1)) / denom
    pm = (probs * valid[..., None]).sum((0, 1)) / denom
    aux = E * torch.sum(f * pm) * aux_loss_weight
    return y.reshape(B, T, H), aux.to(torch.float32)
