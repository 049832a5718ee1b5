"""``llama:...`` and ``synthllm:...`` model specs (counterpart of
``zoo_tpu/serving/llm/spec.py``; tensor-parallel ``tp=`` comes with a
later slice).

* ``llama:tiny`` — the test topology (:func:`tiny_llama_config`);
* ``llama:tiny:seed=3,slots=4,block=8,blocks=64,buckets=16/64`` —
  key=value overrides after the preset (also ``chunk=N``,
  ``overlap=0/1``, ``prefix_cache=0/1``, ``kv=f32|bf16|int8``,
  ``prefill_impl=``, and ``spec_k=N`` / ``spec_ngram=N`` for
  speculative decoding: ``spec_k`` is a model shape, the verify pass's
  width, ``spec_ngram`` the engine's drafter policy; ``role=prefill|``
  ``decode|mixed``, the engine's disaggregation role);
* ``llama:vocab=128256,hidden=4096,n_block=32,n_head=32,n_kv_head=8,``
  ``intermediate=14336`` — explicit architecture (``rope_theta`` keeps
  the :class:`LlamaConfig` default, 500000).

* ``synthllm:slots=2,block=4,blocks=64,tables=8`` — the deterministic
  stand-in of :mod:`zoo_tpu_torch.serving.llm.synthetic` (host only, no
  kernel) behind a real engine, for chaos smokes and benches.

Engine settings resolve env (``ZOO_LLM_*``) < spec < explicit kwargs.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

from zoo_tpu_torch.common.knobs import value as knob_value

LLM_PREFIX = "llama:"

_ARCH_KEYS = ("vocab", "hidden", "n_block", "n_head", "n_kv_head",
              "intermediate")
_ENGINE_KEYS = {"slots": "num_slots", "block": "block_size",
                "blocks": "num_blocks", "tables": "max_blocks_per_seq",
                "seed": "seed", "eos": "eos_id", "chunk": "prefill_chunk",
                "overlap": "overlap", "prefix_cache": "prefix_cache",
                "spec_k": "spec_k", "spec_ngram": "spec_ngram"}
_STR_KEYS = {"kv": "kv_dtype", "prefill_impl": "prefill_impl",
             "role": "role"}


# the deterministic engine (chaos smokes / transport benches):
# synthllm:slots=2,block=4,blocks=64,tables=8 — the generate-path twin
# of the predict path's synthetic:double (see llm/synthetic.py)
SYNTH_LLM_PREFIX = "synthllm:"
_SYNTH_KEYS = {"slots": "num_slots", "block": "block_size",
               "blocks": "num_blocks", "tables": "max_blocks_per_seq",
               "max_prompt": "max_prompt_len", "eos": "eos_id",
               "chunk": "prefill_chunk"}


def is_llm_spec(spec) -> bool:
    return isinstance(spec, str) and spec.startswith(
        (LLM_PREFIX, SYNTH_LLM_PREFIX))


def _parse_kv(parts) -> Dict[str, str]:
    out = {}
    for part in parts:
        for kv in part.split(","):
            if not kv:
                continue
            if "=" not in kv:
                raise ValueError(f"malformed llama spec component {kv!r} "
                                 "(expected key=value)")
            k, v = kv.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def parse_llm_spec(spec: str) -> Tuple[Dict, Dict]:
    """``(config_kwargs, engine_kwargs)`` from a ``llama:...`` spec."""
    if not is_llm_spec(spec):
        raise ValueError(f"not an llm spec: {spec!r}")
    body = spec[len(LLM_PREFIX):]
    parts = body.split(":") if body else [""]
    preset = parts[0] if parts[0] and "=" not in parts[0] else None
    kvs = _parse_kv(parts[1:] if preset else parts)

    cfg_kwargs: Dict = {}
    if preset == "tiny" or preset is None and not any(
            k in kvs for k in _ARCH_KEYS):
        from zoo_tpu_torch.models.llm.llama import tiny_llama_config
        cfg_kwargs = dict(tiny_llama_config().__dict__)
        cfg_kwargs.pop("tie_embeddings", None)
    elif preset is not None and preset != "tiny":
        raise ValueError(f"unknown llama preset {preset!r} "
                         "(supported: tiny, or explicit key=value dims)")
    for k in _ARCH_KEYS:
        if k in kvs:
            cfg_kwargs[k] = int(kvs.pop(k))

    eng: Dict = {}
    for short, name in _ENGINE_KEYS.items():
        if short in kvs:
            eng[name] = int(kvs.pop(short))
    for short, name in _STR_KEYS.items():
        if short in kvs:
            eng[name] = kvs.pop(short)
    if "buckets" in kvs:
        eng["prefill_buckets"] = tuple(
            int(b) for b in kvs.pop("buckets").split("/"))
    if kvs:
        raise ValueError(f"unknown llama spec keys {sorted(kvs)}")
    return cfg_kwargs, eng


def _env_engine_defaults() -> Dict:
    """ZOO_LLM_* env knobs (the per-replica deployment surface)."""
    out: Dict = {}
    for env, name in (("ZOO_LLM_SLOTS", "num_slots"),
                      ("ZOO_LLM_BLOCK_SIZE", "block_size"),
                      ("ZOO_LLM_KV_BLOCKS", "num_blocks"),
                      ("ZOO_LLM_MAX_BLOCKS_PER_SEQ", "max_blocks_per_seq"),
                      ("ZOO_LLM_SEED", "seed"),
                      ("ZOO_LLM_EOS", "eos_id"),
                      ("ZOO_LLM_PREFILL_CHUNK", "prefill_chunk")):
        if os.environ.get(env):
            out[name] = int(knob_value(env))
    if os.environ.get("ZOO_LLM_PREFILL_BUCKETS"):
        out["prefill_buckets"] = tuple(
            int(b) for b in knob_value("ZOO_LLM_PREFILL_BUCKETS").split("/"))
    return out


def build_synthetic_engine(spec: str, mode: Optional[str] = None,
                           start: bool = True, **overrides):
    """An :class:`LLMEngine` over a deterministic
    :class:`~zoo_tpu_torch.serving.llm.synthetic.SyntheticLLMModel` from
    a ``synthllm:...`` spec — real allocator, scheduler, deadlines and
    dedup; pure-function tokens computed on the host."""
    from zoo_tpu_torch.serving.llm.engine import LLMEngine
    from zoo_tpu_torch.serving.llm.synthetic import SyntheticLLMModel

    kvs = _parse_kv(spec[len(SYNTH_LLM_PREFIX):].split(":"))
    kwargs = {}
    for short, name in _SYNTH_KEYS.items():
        if short in kvs:
            kwargs[name] = int(kvs.pop(short))
    role = kvs.pop("role", None) or overrides.pop("role", None)
    if kvs:
        raise ValueError(f"unknown synthllm spec keys {sorted(kvs)}")
    kwargs.update({k: v for k, v in overrides.items()
                   if k not in ("mode", "max_waiting")})
    model = SyntheticLLMModel(**kwargs)
    engine = LLMEngine(model, mode=mode or "continuous",
                       max_waiting=overrides.get("max_waiting"),
                       role=role)
    return engine.start() if start else engine


def build_llm_engine(spec: str, mode: Optional[str] = None,
                     start: bool = True, device=None, **overrides):
    """An :class:`LLMEngine` (started unless ``start=False``) from a
    ``llama:...`` spec on ``device`` (default: the current CUDA device;
    raises without one), or from a ``synthllm:...`` spec (host only:
    ``device`` is not used). ``overrides`` are engine/model kwargs that
    win over both the spec and the env (e.g. ``params=`` to share
    weights, ``decode_impl``/``prefill_impl``/``attention_impl``)."""
    if spec.startswith(SYNTH_LLM_PREFIX):
        return build_synthetic_engine(spec, mode=mode, start=start,
                                      **overrides)
    from zoo_tpu_torch.models.llm.llama import LlamaConfig
    from zoo_tpu_torch.serving.llm.engine import LLMEngine
    from zoo_tpu_torch.serving.llm.model import PagedLlamaModel

    cfg_kwargs, eng_kwargs = parse_llm_spec(spec)
    merged = dict(_env_engine_defaults())
    merged.update(eng_kwargs)
    merged.update({k: v for k, v in overrides.items()
                   if k not in ("mode", "max_waiting")})
    # overlap and prefix_cache are ENGINE settings, not model shapes
    overlap = merged.pop("overlap", None)
    if overlap is not None:
        overlap = bool(int(overlap))
    prefix_cache = merged.pop("prefix_cache", None)
    if prefix_cache is not None:
        prefix_cache = bool(int(prefix_cache))
    # spec_k stays in `merged` (the model's verify width); spec_ngram is
    # the engine's drafter policy
    spec_ngram = merged.pop("spec_ngram", None)
    # role and tenancy are scheduler policy: spec `role=` (or a
    # `role=`/`tenancy=` override) < ZOO_LLM_ROLE / ZOO_TENANT_CONFIG,
    # which the engine reads when none is given
    role = merged.pop("role", None)
    tenancy = merged.pop("tenancy", None)
    model = PagedLlamaModel(LlamaConfig(**cfg_kwargs), device=device,
                            **merged)
    engine = LLMEngine(model, mode=mode or knob_value("ZOO_LLM_MODE"),
                       max_waiting=overrides.get("max_waiting"),
                       overlap=overlap, prefix_cache=prefix_cache,
                       spec_ngram=spec_ngram, role=role, tenancy=tenancy)
    return engine.start() if start else engine
