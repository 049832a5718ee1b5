"""The ``ZOO_*`` knobs the ported serving path reads.

A copy of the entries of ``zoo_tpu/common/knobs.py`` that this package
needs, with the same names, types and defaults, so one environment
configures both packages the same way. :func:`value` parses a knob with
its registered type and default, exactly as the reference registry does.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict

__all__ = ["Knob", "KNOBS", "get", "value"]

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    type: str      # "int" | "float" | "bool" | "str"
    default: object
    help: str

    def read(self, env=None):
        """Unset/empty -> default; malformed numerics warn and fall
        back; bools treat ``0/false/off/no`` as False."""
        env = os.environ if env is None else env
        raw = env.get(self.name)
        if raw is None or raw == "":
            return self.default
        if self.type == "str":
            return raw
        if self.type == "bool":
            return raw.strip().lower() not in ("0", "false", "off", "no")
        try:
            return int(float(raw)) if self.type == "int" else float(raw)
        except ValueError:
            logger.warning("bad %s=%r; using %s", self.name, raw,
                           self.default)
            return self.default


KNOBS: Dict[str, Knob] = {}


def _k(name: str, type: str, default, help: str):
    KNOBS[name] = Knob(name, type, default, help)


_k("ZOO_LLM_SLOTS", "int", 8, "decode slots (the fixed decode batch)")
_k("ZOO_LLM_BLOCK_SIZE", "int", 16, "tokens per KV block")
_k("ZOO_LLM_KV_BLOCKS", "int", 128, "pool size (block 0 is reserved)")
_k("ZOO_LLM_MAX_BLOCKS_PER_SEQ", "int", 32,
   "block-table width = context ceiling / block_size")
_k("ZOO_LLM_PREFILL_BUCKETS", "str", "32/128/512",
   "prompt-length buckets of the whole-prompt prefill")
_k("ZOO_LLM_PREFILL_CHUNK", "int", 0,
   "chunked prefill: feed prompts in N-token slices (0 = off)")
_k("ZOO_LLM_PREFILL_BUDGET", "int", 0,
   "prompt tokens fed per tick when chunking (0 = the chunk size)")
_k("ZOO_LLM_OVERLAP", "bool", True, "the double-buffered tick pipeline")
_k("ZOO_LLM_PREFIX_CACHE", "bool", False,
   "content-hash block reuse with copy-on-write")
_k("ZOO_LLM_KV_DTYPE", "str", "f32", "KV cache dtype: f32 / bf16 / int8")
_k("ZOO_LLM_DECODE_IMPL", "str", "auto",
   "decode attention: flash (CUDA kernel) / dense (plain PyTorch)")
_k("ZOO_LLM_PREFILL_IMPL", "str", "auto",
   "chunk-prefill attention: flash (CUDA kernel) / dense")
_k("ZOO_LLM_DECODE_SPLITS", "int", 4,
   "split-KV width of the paged decode kernel")
_k("ZOO_LLM_SEED", "int", 0, "weight seed for spec-built params")
_k("ZOO_LLM_EOS", "int", None, "eos token id (stops a stream early)")
_k("ZOO_LLM_MODE", "str", "continuous",
   "`oneshot` = request-level baseline")
_k("ZOO_LLM_MAX_WAITING", "int", 256,
   "waiting-queue bound (overflow sheds retryable)")
_k("ZOO_LLM_FINISHED_CACHE", "int", 256, "finished-stream dedup LRU")
_k("ZOO_LLM_SAMPLING", "str", "",
   "deployment-default sampling, e.g. `temperature=0.8,top_k=40`")
_k("ZOO_LLAMA_FLASH_MIN_SEQ", "int", 512,
   "sequence length from which attention `auto` picks the flash kernel")
_k("ZOO_LLAMA_ATTN_IMPL", "str", "",
   "force `dense` / `flash` attention for A/B runs")


def get(name: str) -> Knob:
    try:
        return KNOBS[name]
    except KeyError:
        raise KeyError(f"{name} is not a knob of zoo_tpu_torch") from None


def value(name: str, env=None):
    """Parse knob ``name`` from the environment (see :meth:`Knob.read`)."""
    return get(name).read(env)
