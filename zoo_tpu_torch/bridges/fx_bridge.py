"""A torch module as a trainable model of the port, through ``torch.export``
(counterpart of ``zoo_tpu/bridges/fx_bridge.py``).

The module is traced once, in ``eval()`` mode and on the CPU, into a
core-ATen graph (``run_decompositions()``), with the batch dimension
symbolic where the module allows it. Its parameters, buffers and
constants are taken by their torch FQNs. The JAX package interprets that
graph in JAX, one table entry per ATen op (``_OPS``); the port keeps the
same table, keyed by the same 135 op names, and runs the graph in torch:

* most entries are the ATen op itself (:data:`KEEP`), which the graph
  already calls;
* the rest keep the JAX entries' deliberate casts and contracts: int64
  made int32 and float64 made float32 (parameters, buffers, constants,
  factory and cast dtypes, ``argmax``), ``view`` as a reshape (``clone``
  and ``contiguous`` are no copies, as in JAX), ``detach`` as the
  identity (gradients flow through it, as in JAX), dropout as the
  identity (the graph is an eval-mode trace), the in-place activations
  out of place;
* every factory op (``full``, ``zeros``, ``ones``, ``arange``,
  ``scalar_tensor``) creates on the device of the model's parameters
  (of its first input when it has none), not on the trace's device that
  the graph names, and ``_to_copy`` never moves a tensor.

The table is resolved once, at conversion: each node's target is
rewritten to its entry and the graph module recompiled, so a call runs
FX's generated straight-line code. An op outside the table raises
``NotImplementedError`` naming it at conversion (the JAX package raises
at the first call).

:class:`TorchGraphNet` presents the converted graph as a
:class:`~zoo_tpu_torch.pipeline.api.keras.engine.topology.KerasNet`
(``params = {"torch_graph": {"w": parameters, "stats": buffers}}``), so
``fit``, the training guard, checkpoints and the XShards feed drive it
unchanged. Its weights persist through ``save_weights`` and checkpoints;
a whole-model file of it is refused (ROADMAP C).
"""

from __future__ import annotations

import copy
import operator
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from zoo_tpu_torch.pipeline.api.keras.engine.topology import KerasNet

#: a table entry that runs the node's own ATen op
KEEP = "aten"

_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32}


def _narrow(dtype):
    """A dtype as the JAX package computes it (x64 off)."""
    return _NARROW.get(dtype, dtype)


def _t2t(t: torch.Tensor) -> torch.Tensor:
    """A detached CPU copy of a traced tensor, int64 made int32 and
    float64 made float32 (the JAX bridge's ``_t2j``)."""
    t = t.detach()
    return t.to(_narrow(t.dtype)).clone()


# --------------------------------------------------------------------- ops
# named functions, not lambdas: FX's code generation names each target

def _identity(x, *args, **kwargs):
    return x


def _no_op(*args, **kwargs):
    return None


def _sym_size(x, d):
    return x.shape[d]


def _reshape(x, shape):
    return torch.reshape(x, [int(s) for s in shape])


def _relu(x):
    return F.relu(x)


def _silu(x):
    return F.silu(x)


def _hardtanh(x, mn=-1.0, mx=1.0):
    return F.hardtanh(x, mn, mx)


def _gelu(x, approximate="none"):
    return F.gelu(x, approximate=approximate)


def _argmax(x, dim=None, keepdim=False):
    return torch.argmax(x, dim, keepdim).to(torch.int32)


def _gather(x, dim, index, sparse_grad=False):
    return torch.gather(x, dim, index.long())


def _dtype_kw(dtype):
    return {} if dtype is None else {"dtype": _narrow(dtype)}


def _cumsum(x, dim, dtype=None):
    return torch.cumsum(x, dim, **_dtype_kw(dtype))


def _sum(x, dim=None, keepdim=False, dtype=None):
    if dim is None or (isinstance(dim, (list, tuple)) and not dim):
        return torch.sum(x, **_dtype_kw(dtype))
    return torch.sum(x, dim, keepdim, **_dtype_kw(dtype))


def _mean(x, dim=None, keepdim=False, dtype=None):
    if dim is None or (isinstance(dim, (list, tuple)) and not dim):
        return torch.mean(x, **_dtype_kw(dtype))
    return torch.mean(x, dim, keepdim, **_dtype_kw(dtype))


def _dropout(x, p, train=None):
    # an eval-mode trace: dropout is the identity (the JAX contract)
    return x


def _native_dropout(x, p, train=None):
    return x, torch.ones_like(x, dtype=torch.bool)


def _full(size, fill_value, dtype=None, layout=None, device=None,
          pin_memory=None, like=None):
    if dtype is None and isinstance(fill_value, int) and \
            not isinstance(fill_value, bool):
        dtype = torch.int32
    return torch.full([int(s) for s in size], fill_value,
                      device=like.device, **_dtype_kw(dtype))


def _zeros(size, dtype=None, layout=None, device=None, pin_memory=None,
           like=None):
    return torch.zeros([int(s) for s in size], device=like.device,
                       **_dtype_kw(dtype))


def _ones(size, dtype=None, layout=None, device=None, pin_memory=None,
          like=None):
    return torch.ones([int(s) for s in size], device=like.device,
                      **_dtype_kw(dtype))


def _scalar_tensor(value, dtype=None, layout=None, device=None,
                   pin_memory=None, like=None):
    if dtype is None and isinstance(value, int) and \
            not isinstance(value, bool):
        dtype = torch.int32
    return torch.scalar_tensor(value, device=like.device,
                               **_dtype_kw(dtype))


def _arange(*args, dtype=None, layout=None, device=None, pin_memory=None,
            like=None):
    if dtype is None and all(isinstance(a, int) and not isinstance(a, bool)
                             for a in args):
        dtype = torch.int32
    return torch.arange(*args, device=like.device, **_dtype_kw(dtype))


def _full_like(x, fill_value, dtype=None, **kwargs):
    return torch.full_like(x, fill_value, **_dtype_kw(dtype))


def _zeros_like(x, dtype=None, **kwargs):
    return torch.zeros_like(x, **_dtype_kw(dtype))


def _ones_like(x, dtype=None, **kwargs):
    return torch.ones_like(x, **_dtype_kw(dtype))


def _to_copy(x, dtype=None, layout=None, device=None, pin_memory=None,
             non_blocking=False, memory_format=None):
    # a copy never moves: the tensor stays on the model's device
    return x if dtype is None else x.to(_narrow(dtype))


_OPS: Dict[str, Any] = {}


def _op(fn, *names):
    for n in names:
        _OPS[n] = fn


_op(KEEP, "aten.add.Tensor", "aten.add.Scalar", "aten.sub.Tensor",
    "aten.sub.Scalar", "aten.rsub.Scalar", "aten.rsub.Tensor",
    "aten.mul.Tensor", "aten.mul.Scalar", "aten.div.Tensor",
    "aten.div.Scalar", "aten.pow.Tensor_Scalar", "aten.pow.Tensor_Tensor",
    "aten.neg.default", "aten.abs.default", "aten.exp.default",
    "aten.log.default", "aten.sqrt.default", "aten.rsqrt.default",
    "aten.erf.default", "aten.tanh.default", "aten.sin.default",
    "aten.cos.default", "aten.reciprocal.default", "aten.relu.default",
    "aten.sigmoid.default", "aten.silu.default", "aten.maximum.default",
    "aten.minimum.default", "aten.floor.default", "aten.round.default",
    "aten.logical_not.default", "aten.logical_and.default",
    "aten.logical_or.default", "aten.bitwise_not.default",
    "aten.eq.Scalar", "aten.eq.Tensor", "aten.ne.Scalar", "aten.ne.Tensor",
    "aten.lt.Scalar", "aten.lt.Tensor", "aten.le.Scalar", "aten.le.Tensor",
    "aten.gt.Scalar", "aten.gt.Tensor", "aten.ge.Scalar", "aten.ge.Tensor",
    "aten.where.self", "aten.clamp.default", "aten.hardtanh.default",
    "aten.leaky_relu.default", "aten.elu.default", "aten.gelu.default",
    "aten.mm.default", "aten.bmm.default", "aten.matmul.default",
    "aten.addmm.default", "aten.baddbmm.default", "aten.t.default",
    "aten.permute.default", "aten.transpose.int", "aten.unsqueeze.default",
    "aten.squeeze.dim", "aten.squeeze.dims", "aten.expand.default",
    "aten.cat.default", "aten.stack.default", "aten.split.Tensor",
    "aten.split_with_sizes.default", "aten.slice.Tensor",
    "aten.select.int", "aten.index_select.default",
    "aten.embedding.default", "aten.masked_fill.Scalar",
    "aten.masked_fill.Tensor", "aten.tril.default", "aten.triu.default",
    "aten.var.correction", "aten.amax.default", "aten.amin.default",
    "aten.any.dim", "aten.any.default", "aten.all.dim", "aten.all.default",
    "aten._softmax.default", "aten.softmax.int",
    "aten._log_softmax.default", "aten.log_softmax.int",
    "aten.native_layer_norm.default",
    "aten._native_batch_norm_legit_no_training.default",
    "aten.native_group_norm.default", "aten.convolution.default",
    "aten.max_pool2d.default", "aten.max_pool2d_with_indices.default",
    "aten.avg_pool2d.default", "aten._adaptive_avg_pool2d.default",
    "aten.adaptive_avg_pool2d.default", "aten.type_as.default",
    "aten.repeat.default", "aten.flatten.using_ints",
    "aten.constant_pad_nd.default")
_op(_identity, "aten.clone.default", "aten.alias.default",
    "aten.detach.default", "aten.lift_fresh.default",
    "aten.contiguous.default")
_op(_no_op, "aten._assert_tensor_metadata.default")
_op(_sym_size, "aten.sym_size.int")
_op(_reshape, "aten.view.default", "aten.reshape.default",
    "aten._unsafe_view.default")
_op(_relu, "aten.relu_.default")
_op(_silu, "aten.silu_.default")
_op(_hardtanh, "aten.hardtanh_.default")
_op(_gelu, "aten.gelu_.default")
_op(_argmax, "aten.argmax.default")
_op(_gather, "aten.gather.default")
_op(_cumsum, "aten.cumsum.default")
_op(_sum, "aten.sum.dim_IntList", "aten.sum.default")
_op(_mean, "aten.mean.dim", "aten.mean.default")
_op(_dropout, "aten.dropout.default")
_op(_native_dropout, "aten.native_dropout.default")
_op(_full, "aten.full.default")
_op(_zeros, "aten.zeros.default")
_op(_ones, "aten.ones.default")
_op(_scalar_tensor, "aten.scalar_tensor.default")
_op(_arange, "aten.arange.default", "aten.arange.start",
    "aten.arange.start_step")
_op(_full_like, "aten.full_like.default")
_op(_zeros_like, "aten.zeros_like.default")
_op(_ones_like, "aten.ones_like.default")
_op(_to_copy, "aten._to_copy.default", "aten.to.dtype")

#: the factory entries: they take ``like=``, the tensor whose device
#: they create on
_FACTORIES = (_full, _zeros, _ones, _scalar_tensor, _arange)


def _entry(target):
    """The table entry of an ATen target, with the JAX lookup's fall
    back to the op's ``.default`` overload; raises naming the op."""
    key = str(target)
    fn = _OPS.get(key)
    if fn is None:
        fn = _OPS.get(key.rsplit(".", 1)[0] + ".default")
    if fn is None:
        raise NotImplementedError(
            f"ATen op {key} has no mapping in the bridge; add a handler "
            "to zoo_tpu_torch.bridges.fx_bridge._OPS")
    return fn


def _passes_through(target) -> bool:
    """``operator.getitem`` and the symbolic-shape arithmetic (plain
    ``operator``/``math`` calls on Python ints) run as they are."""
    return target is operator.getitem or getattr(
        target, "__module__", None) in ("operator", "_operator", "math")


def resolve_graph(gm: torch.fx.GraphModule, like_node) -> List[str]:
    """Rewrite every ATen node of ``gm`` to its table entry (a factory
    entry gets ``like=like_node``) and recompile; returns the sorted ATen
    op names of the graph. Raises ``NotImplementedError`` on an op
    outside the table and on a node that is not a function call."""
    ops = set()
    for node in gm.graph.nodes:
        if node.op in ("placeholder", "output"):
            continue
        if node.op != "call_function":
            raise NotImplementedError(f"fx node op {node.op}")
        if _passes_through(node.target):
            continue
        ops.add(str(node.target))
        fn = _entry(node.target)
        if fn is KEEP:
            continue
        node.target = fn
        if fn in _FACTORIES:
            kwargs = dict(node.kwargs)
            kwargs.pop("device", None)
            kwargs["like"] = like_node
            node.kwargs = kwargs
    gm.recompile()
    return sorted(ops)


# ----------------------------------------------------------- converter

class ConvertedModule:
    """A traced torch module as ``fn(params, buffers, *inputs)``, params
    and buffers dicts keyed by torch FQN. Outputs follow the module's
    flattened output order (a single tensor unwrapped). ``ops`` holds
    the ATen ops of the graph."""

    def __init__(self, graph_module, input_specs, output_specs,
                 params: Dict[str, torch.Tensor],
                 buffers: Dict[str, torch.Tensor],
                 constants: Dict[str, torch.Tensor],
                 input_shapes: List[Tuple], ops: Sequence[str] = ()):
        from torch.export.graph_signature import InputKind, OutputKind

        self.gm = graph_module
        self.input_specs = input_specs
        self.output_specs = output_specs
        self.params = params
        self.buffers = buffers
        self.constants = constants
        self.input_shapes = input_shapes
        self.ops = list(ops)
        kinds = {InputKind.PARAMETER: "p", InputKind.BUFFER: "b",
                 InputKind.CONSTANT_TENSOR: "c",
                 InputKind.USER_INPUT: "u"}
        slots = []
        for spec in input_specs:
            if spec.kind not in kinds:
                raise NotImplementedError(f"input kind {spec.kind}")
            slots.append((kinds[spec.kind], spec.target))
        self._slots = slots
        self._user_outputs = [i for i, s in enumerate(output_specs)
                              if s.kind == OutputKind.USER_OUTPUT]
        self._placed_constants: Dict[torch.device, Dict] = {}

    def _constants_on(self, dev: torch.device) -> Dict[str, torch.Tensor]:
        placed = self._placed_constants.get(dev)
        if placed is None:
            placed = {k: v.to(dev) for k, v in self.constants.items()}
            self._placed_constants = {dev: placed}
        return placed

    def __call__(self, params: Dict[str, Any], buffers: Dict[str, Any],
                 *user_inputs):
        dev = (next(iter(params.values())) if params
               else user_inputs[0]).device
        constants = self._constants_on(dev)
        it_user = iter(user_inputs)
        args = []
        for kind, target in self._slots:
            if kind == "p":
                args.append(params[target])
            elif kind == "b":
                args.append(buffers[target])
            elif kind == "c":
                args.append(constants[target])
            else:
                args.append(next(it_user))
        result = self.gm(*args)
        outs = [result[i] for i in self._user_outputs]
        return outs[0] if len(outs) == 1 else tuple(outs)


def _cpu_twin(module):
    """The module itself when every tensor of it is on the CPU, else a
    CPU copy: a trace on the card can decompose attention into CUDA-only
    ops that the table lacks, where the CPU trace gives ``bmm`` and
    ``_softmax``."""
    tensors = list(module.parameters()) + list(module.buffers())
    if all(t.device.type == "cpu" for t in tensors):
        return module
    return copy.deepcopy(module).cpu()


def convert_torch_export(module, example_args: Sequence,
                         example_kwargs: Optional[dict] = None
                         ) -> ConvertedModule:
    """Trace ``module`` (eval mode, on the CPU) with ``torch.export`` and
    return a :class:`ConvertedModule` holding CPU copies of its weights.
    """
    was_training = getattr(module, "training", False)
    traced = _cpu_twin(module.eval())
    args = tuple(
        a.detach().cpu() if isinstance(a, torch.Tensor)
        else torch.as_tensor(np.asarray(a)) for a in example_args)
    # a shared symbolic batch dim keeps the traced graph batch-size
    # polymorphic (otherwise view/expand bake in the example batch);
    # fall back to a static trace for modules whose forward constrains it
    try:
        batch = torch.export.Dim("batch", min=1)
        dyn = tuple({0: batch} if a.ndim > 0 else None for a in args)
        ep = torch.export.export(traced, args,
                                 kwargs=example_kwargs or None,
                                 dynamic_shapes=dyn)
    except Exception:
        ep = torch.export.export(traced, args,
                                 kwargs=example_kwargs or None)
    ep = ep.run_decompositions()
    sig = ep.graph_signature
    params = {k: _t2t(v) for k, v in ep.state_dict.items()
              if k in set(sig.parameters)}
    buffers = {k: _t2t(v) for k, v in ep.state_dict.items()
               if k in set(sig.buffers)}
    constants = {k: _t2t(v) for k, v in ep.constants.items()
                 if isinstance(v, torch.Tensor)}
    # non-persistent buffers (e.g. HF position_ids) are excluded from
    # state_dict and carried in ep.constants instead
    for k in sig.buffers:
        if k not in buffers and k in constants:
            buffers[k] = constants[k]
    placeholders = {n.name: n for n in ep.graph_module.graph.nodes
                    if n.op == "placeholder"}
    firsts = [s for s in sig.input_specs if s.kind.name == "PARAMETER"] \
        or [s for s in sig.input_specs if s.kind.name == "USER_INPUT"]
    like = placeholders[firsts[0].arg.name] if firsts else None
    ops = resolve_graph(ep.graph_module, like)
    if was_training:
        module.train()
    return ConvertedModule(ep.graph_module, sig.input_specs,
                           sig.output_specs, params, buffers, constants,
                           [tuple(a.shape) for a in args], ops)


# ------------------------------------------------------ KerasNet adapter

class TorchGraphNet(KerasNet):
    """A :class:`ConvertedModule` presented through the KerasNet surface,
    so the port's ``fit`` (the guard, superbatches, checkpoints,
    summaries) drives a traced torch model unchanged. Buffers ride in the
    ``stats`` subtree, which the train step keeps out of the gradient."""

    def __init__(self, converted: ConvertedModule, output_index: int = 0,
                 name: Optional[str] = None):
        super().__init__(name=name or "torch_graph")
        self.converted = converted
        self.output_index = output_index
        self.params = {"torch_graph": {"w": dict(converted.params),
                                       "stats": dict(converted.buffers)}}
        self._built_shapes = [(None,) + tuple(s[1:])
                              for s in converted.input_shapes]

    @property
    def layers(self):
        return []

    def _input_shapes(self):
        return self._built_shapes

    def _init_params(self, generator, input_shapes):
        return self.params

    def _forward(self, params, inputs, *, training, collect=None, rng=None):
        g = params["torch_graph"]
        out = self.converted(g["w"], g.get("stats", {}), *inputs)
        if isinstance(out, tuple):
            out = out[self.output_index]
        return out

    def to_bytes(self) -> bytes:
        raise NotImplementedError(
            f"{self.name}: a traced torch model has no whole-model file "
            "in the port; keep its weights with save_weights or the "
            "estimator's checkpoints and trace the module again (the JAX "
            "package's save writes a file its own load cannot read)")


def torch_to_graph_net(module, example_inputs: Sequence,
                       output_index: int = 0) -> TorchGraphNet:
    """One call from a torch module to a trainable KerasNet (traced, its
    weights imported)."""
    return TorchGraphNet(convert_torch_export(module, example_inputs),
                         output_index=output_index)
