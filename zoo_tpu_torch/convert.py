"""Parameters of the JAX package, as numpy, into the port.

``params_from_jax(tree)`` takes the parameter pytree of a ``zoo_tpu``
Llama (``embed``, ``blocks/{wq, wk, wv, wo, attn_norm, mlp_norm,
w_gate, w_up, w_down}``, ``final_norm``, ``head``) or MoELlama (its
blocks also hold ``router`` and (n_block, E, ...) expert banks), with
its leaves already turned into numpy arrays by the caller, and returns
the same tree of torch tensors on ``device``, every key carried; a key
it does not know is refused, never dropped. The layout is kept: ``(in, out)``
matrices and ``(n_block, ...)`` stacked block tensors, so ``x @ w`` is
the same product in both packages.

``keras_params_from_jax(tree)`` takes a Keras model's whole params tree
(``{"000_llama": {...}, ...}``, layer keys as the JAX package makes
them) or a fused AdamW state ``{"m", "v", "step"}``, numpy leaves, and
returns the same tree of tensors (``step`` as an int): the recurrent
layers' ``W`` (in, g * units), ``U`` (units, g * units) and ``b``,
``Bidirectional``'s ``{"fw", "bw"}`` pair and ``Conv1D``'s ``W``
(k, cin, cout) load by name, as the port lays them out alike; so do the
Chronos trees: the Seq2seq core's ``enc_i``/``dec_i`` cells, ``bridge``
(``w``, ``b``, or a custom layer's tree), ``gen`` and the ``enc_emb``/
``dec_emb`` tables, the TCN blocks' WIO ``W1``/``W2`` (k, cin, cout),
``b1``/``b2`` and the 1x1 ``Wskip``, and MTNet's shared conv and GRU,
its heads and its bias-free AR ``Dense``. Each int8 conv
weight ``W_q`` gets the K-major copy the int8 conv kernel reads
(:func:`~zoo_tpu_torch.ops.kernels.conv.attach_kmajor`), kept beside the
tree, not in it.

``ssd_from_jax(model)`` and ``caffe_net_from_jax(net)`` build the
port's ``SSD`` and ``CaffeNet`` from a JAX one: its configuration (a
Caffe net's layers, inputs and shapes) and its params, same keys.

``tcmf_from_jax(fc)`` carries a fitted JAX ``TCMFForecaster`` (``F``,
``X``, the AR coefficients and lag, the normalisation, and its TCN's
weights and layer names) into the port's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from zoo_tpu_torch.common.device import resolve_device
from zoo_tpu_torch.models.llm.llama import BLOCK_KEYS
from zoo_tpu_torch.models.llm.moe_llama import MOE_KEYS
from zoo_tpu_torch.ops.kernels.conv import attach_kmajor


#: the keys a Llama tree of either package may hold, at its top and in
#: its stacked blocks (a dense block's, or an MoE block's router and
#: (n_block, E, H, F) banks)
_LLAMA_KEYS = {"embed", "blocks", "final_norm", "head"}
_LLAMA_BLOCK_KEYS = set(BLOCK_KEYS) | set(MOE_KEYS)


def params_from_jax(tree: Dict, device=None) -> Dict:
    dev = resolve_device(device)
    for have, known, where in ((tree, _LLAMA_KEYS, "the tree"),
                               (tree["blocks"], _LLAMA_BLOCK_KEYS,
                                "a block")):
        unknown = sorted(set(have) - known)
        if unknown:
            raise ValueError(
                f"params_from_jax: {where} holds keys the port's Llama "
                f"does not know: {unknown}")

    def conv(x):
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    out = {"embed": conv(tree["embed"]),
           "blocks": {k: conv(v) for k, v in tree["blocks"].items()},
           "final_norm": conv(tree["final_norm"])}
    if "head" in tree:
        out["head"] = conv(tree["head"])
    return out


def _tensors(node, dev):
    if isinstance(node, dict):
        out = {k: _tensors(v, dev) for k, v in node.items()}
        w_q = out.get("W_q")
        if w_q is not None and w_q.dim() == 4:
            # an int8 conv weight: attach the kernel's K-major copy once
            attach_kmajor(w_q)
        return out
    return torch.from_numpy(np.array(node, copy=True)).to(dev)


def keras_params_from_jax(tree: Dict, device=None) -> Dict:
    dev = resolve_device(device)
    if set(tree) == {"m", "v", "step"}:   # the fused AdamW state
        return {"m": _tensors(tree["m"], dev), "v": _tensors(tree["v"], dev),
                "step": int(np.asarray(tree["step"]))}
    return _tensors(tree, dev)


def tcmf_from_jax(fc, device=None):
    """The port's ``TCMFForecaster`` holding a fitted JAX forecaster's
    state: its hyperparameters, ``F``, ``X``, ``ar`` and lag, the
    normalisation's mean and std, and with ``temporal_model="tcn"`` a
    TCN carrying the JAX TCN's weights (and its layers' names, from
    which dropout keys derive), on ``device``."""
    from zoo_tpu_torch.chronos.forecaster.tcmf_forecaster import (
        TCMFForecaster,
    )
    out = TCMFForecaster(
        rank=fc.rank, ar_lag=fc.ar_lag, alt_iters=fc.alt_iters, reg=fc.reg,
        svd=fc.svd, normalize=fc.normalize,
        temporal_model=fc.temporal_model, num_channels_X=fc.num_channels_X,
        kernel_size=fc.kernel_size, dropout=fc.dropout, lr=fc.lr,
        tcn_epochs=fc.tcn_epochs, device=device)
    out.F, out.X, out.ar = (np.array(getattr(fc, k), copy=True)
                            for k in ("F", "X", "ar"))
    if fc.normalize:
        out._mean, out._std = np.array(fc._mean), np.array(fc._std)
    if fc._tcn is not None:
        out._tcn = out._new_tcn()
        tm = out._tcn._ensure_model()
        tm.params = keras_params_from_jax(fc._tcn.model.params,
                                          out._tcn._device())
        for a, b in zip(fc._tcn.model.layers, tm.layers):
            b.name = a.name
        out._tcn.fitted = True
    return out


def ssd_from_jax(jm, device=None):
    """The port's ``SSD`` with a JAX ``SSD``'s configuration (classes,
    input size, channels, aspect ratios) and its params (built if it has
    none) on ``device``: the same keys, HWIO conv weights alike."""
    from zoo_tpu_torch.models.image.objectdetection import SSD
    out = SSD(jm.n_classes, input_size=jm.input_size,
              feature_channels=tuple(jm.channels),
              aspect_ratios=tuple(jm.aspect_ratios), name=jm.name)
    params = jm.params if jm.params is not None else jm.build()
    out.params = keras_params_from_jax(
        {k: _numpy(v) for k, v in params.items()}, device)
    return out


def caffe_net_from_jax(net, device=None):
    """The port's ``CaffeNet`` holding a JAX ``CaffeNet``'s layers (name,
    type, bottoms, tops, attributes), inputs and shapes, and its blobs
    (params, after any training) on ``device``."""
    from zoo_tpu_torch.models.caffe_loader import CaffeLayer, CaffeNet
    layers = [CaffeLayer(l.name, l.type, list(l.bottoms), list(l.tops),
                         [np.asarray(b) for b in l.blobs], dict(l.attrs))
              for l in net.caffe_layers]
    out = CaffeNet(layers, net.inputs, [], name=net.name)
    out._built_shapes = list(net._built_shapes)
    out.params = keras_params_from_jax(_numpy(net.params), device)
    return out


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return np.asarray(tree)
