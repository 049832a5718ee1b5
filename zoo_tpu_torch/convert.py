"""Parameters of the JAX package, as numpy, into the port.

``params_from_jax(tree)`` takes the parameter pytree of a ``zoo_tpu``
Llama (``embed``, ``blocks/{wq, wk, wv, wo, attn_norm, mlp_norm,
w_gate, w_up, w_down}``, ``final_norm``, ``head``), with its leaves
already turned into numpy arrays by the caller, and returns the same
tree of torch tensors on ``device``. The layout is kept: ``(in, out)``
matrices and ``(n_block, ...)`` stacked block tensors, so ``x @ w`` is
the same product in both packages.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from zoo_tpu_torch.common.device import resolve_device
from zoo_tpu_torch.models.llm.llama import BLOCK_KEYS


def params_from_jax(tree: Dict, device=None) -> Dict:
    dev = resolve_device(device)

    def conv(x):
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    out = {"embed": conv(tree["embed"]),
           "blocks": {k: conv(tree["blocks"][k]) for k in BLOCK_KEYS},
           "final_norm": conv(tree["final_norm"])}
    if "head" in tree:
        out["head"] = conv(tree["head"])
    return out
