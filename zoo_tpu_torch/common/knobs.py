"""The ``ZOO_*`` knobs the port reads (serving, its wire path, tenancy
and disaggregation, training, inference).

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
_k("ZOO_LLM_SPEC_K", "int", 0,
   "speculative decoding: the verify pass scores up to N drafted tokens "
   "a slot (0 = off)")
_k("ZOO_LLM_SPEC_NGRAM", "int", 3,
   "longest suffix n-gram the prompt-lookup drafter matches")
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
_k("ZOO_FUSED_OPTIM", "bool", False,
   "AdamW takes the fused direct-apply path")
_k("ZOO_GUARD", "bool", True, "`0` disables the guard estimators attach")
_k("ZOO_GUARD_MAX_SKIPS", "int", 8,
   "consecutive skipped steps before rollback")
_k("ZOO_GUARD_SPIKE_FACTOR", "float", 10.0,
   "window-loss multiple over the rolling median that triggers rollback")
_k("ZOO_GUARD_WINDOW", "int", 32, "rolling-loss window (boundaries)")
_k("ZOO_GUARD_MIN_WINDOW", "int", 5,
   "boundaries before spike detection arms")
_k("ZOO_GUARD_ROLLBACK_BUDGET", "int", 3,
   "rollbacks before `TrainingDiverged`")
_k("ZOO_GUARD_LR_BACKOFF", "float", 0.5, "LR multiplier on rollback resume")
_k("ZOO_GUARD_CHECK_EVERY", "int", 1,
   "read the device counter every N boundaries")
_k("ZOO_GUARD_MAX_GNORM", "float", None,
   "optional hard gradient-norm ceiling")
_k("ZOO_GUARD_QUARANTINE", "str", None,
   "journal path (default `<model_dir>/guard/quarantine.jsonl`)")
_k("ZOO_PREEMPT", "str", "SIGTERM",
   "preemption signal name; `none` disables")
_k("ZOO_CKPT_KEEP", "int", 5,
   "checkpoint retention bound (steps + `.corrupt` dirs; newest verified "
   "step protected)")
_k("ZOO_INT8_MODE", "str", "auto",
   "int8 quantization policy: `auto` microbenches int8 vs float and "
   "keeps the winner, `force`, `off`. The default `auto` is that of "
   "`InferenceModel.load`; `quantize_model` with no `mode=` and the "
   "knob unset forces, as in the JAX package")
_k("ZOO_MODEL_SECRET", "str", None,
   "model decryption secret for encrypted artifacts")
_k("ZOO_MODEL_SALT", "str", None, "salt paired with `ZOO_MODEL_SECRET`")
_k("ZOO_MODEL_ENC_MODE", "str", "cbc",
   "cipher mode for encrypted model artifacts (`cbc`/`gcm`)")
_k("ZOO_CONV_IMPL", "str", "auto",
   "conv2d backend: `auto` (the implicit-GEMM CUDA kernel on a CUDA "
   "device for supported shapes, the reference conv elsewhere), "
   "`pallas` (the kernel), `reference`")
_k("ZOO_INT8_MATMUL", "str", "auto",
   "int8 GEMM backend: `auto`/`fused` (one-kernel quantize+dot+"
   "dequant), `unfused` (quantize pass + dequant matmul kernel)")

# -- the wire path: serving door, HA client, supervision ---------------------
_k("ZOO_SERVE_REQUEST_TIMEOUT", "float", 120.0,
   "server reply bound (seconds) for requests with **no** propagated "
   "deadline")
_k("ZOO_SERVE_HANDSHAKE_TIMEOUT", "float", 10.0,
   "TLS handshake bound (seconds)")
_k("ZOO_SERVE_DEADLINE_MS", "float", 30000.0,
   "HA client default end-to-end budget; `<= 0` = none")
_k("ZOO_SERVE_HEDGE", "bool", True, "HA client hedging on/off")
_k("ZOO_SERVE_HEDGE_DELAY_MS", "float", 0.0,
   "hedge delay; `0` = track p95 (50 ms until warmed)")
_k("ZOO_SERVE_BREAKER_RECOVERY", "float", 1.0,
   "client-side per-replica breaker recovery (seconds)")
_k("ZOO_SERVE_AB_SPLIT", "str", "",
   "client A/B split, e.g. `v2=0.1,v3=0.05` (rest unpinned)")
_k("ZOO_SERVE_MAX_QUEUE", "int", 1024,
   "batcher queue bound; `0` = unbounded (no early shed)")
_k("ZOO_SERVE_DEDUP_CACHE", "int", 1024,
   "request-id LRU entries; `0` disables dedup")
_k("ZOO_SERVE_DRAIN_TIMEOUT_S", "float", 30.0,
   "graceful-drain budget; also the per-replica in-flight budget in "
   "`rolling_update`")
_k("ZOO_REGISTRY_KEEP", "int", 8,
   "registry retention bound (never evicts aliased/pinned versions)")
_k("ZOO_LLM_ROLE", "str", "mixed",
   "replica role (spec: `role=`): `prefill` parks finished prompts "
   "for `kv_migrate` handoff instead of decoding, `decode` adopts "
   "migrated KV, `mixed` does both")
_k("ZOO_KV_MIGRATE_TTL_MS", "float", 2000.0,
   "how long a parked handoff (prefill side) or a staged adoption "
   "payload (decode side) survives before the sweep frees its blocks")
_k("ZOO_KV_MIGRATE_MIN_TOKENS", "int", 16,
   "prompts shorter than this skip the handoff path and run "
   "mixed/decode-local prefill")
_k("ZOO_KV_MIGRATE_CHUNK_BLOCKS", "int", 4,
   "KV blocks packed per `kv_migrate` block frame on the wire")
_k("ZOO_ROUTE_PREFIX_WEIGHT", "float", 1.0,
   "routing weight of the prefix-affinity signal in the HA client's "
   "plan order")
_k("ZOO_ROUTE_OCC_WEIGHT", "float", 0.5,
   "routing weight of decode occupancy (busy slots / total slots from "
   "`llm_stats`) — penalizes loaded seats")
_k("ZOO_QOS", "bool", True,
   "`0` disables the whole tenancy layer even with a tenant config")
_k("ZOO_TENANT_CONFIG", "str", "",
   "tenant spec: `name:field=..,..;name2:..` with fields `weight` "
   "(fair-share), `class` (priority, lower preempts higher), `rate` "
   "(req/s token bucket, 0 = unlimited), `burst` (bucket depth), `kv` "
   "(live KV-block quota), `slots` (decode-slot quota); empty = "
   "tenancy off")
_k("ZOO_TENANT_DEFAULT_WEIGHT", "float", 1.0,
   "fair-share weight for unlisted/unlabeled tenants")
_k("ZOO_TENANT_DEFAULT_CLASS", "int", 1,
   "priority class for unlisted/unlabeled tenants (lower = more "
   "important)")
_k("ZOO_TENANT_DEFAULT_RATE", "float", 0.0,
   "admission rate (req/s) for unlisted/unlabeled tenants (0 = "
   "unlimited)")
_k("ZOO_TENANT", "str", None,
   "the tenant id `HAServingClient` stamps on every request it sends "
   "(per-call `tenant=` overrides)")
_k("ZOO_TENANT_AB_PINS", "str", "",
   "per-tenant version pins for the HA client, `gold=v2,free=v1`")
_k("ZOO_TENANT_BACKOFF_CAP_MS", "float", 2000.0,
   "ceiling on how long the HA client honors a rate-shed "
   "`retry_after_ms` hint before retrying")
_k("ZOO_WIRE_CRC", "bool", True,
   "CRC trailer on every serving frame (negotiated per connection; `0` "
   "disables)")
_k("ZOO_EJECT", "bool", True, "gray-failure ejection in the HA client")
_k("ZOO_EJECT_FACTOR", "float", 3.0,
   "outlier bar: multiple of the healthy-peer median EWMA")
_k("ZOO_EJECT_MIN_MS", "float", 25.0,
   "absolute floor — nothing under it is an outlier")
_k("ZOO_EJECT_MIN_SAMPLES", "int", 5,
   "samples before a seat can be classified")
_k("ZOO_EJECT_EWMA_ALPHA", "float", 0.35, "latency/error EWMA smoothing")
_k("ZOO_EJECT_PROBATION_S", "float", 1.5,
   "sustained degradation before probation → ejected")
_k("ZOO_EJECT_PROBE_S", "float", 0.5, "canary cadence on probation seats")
_k("ZOO_EJECT_READMIT_S", "float", 1.0,
   "ejected → probation backoff base (doubles per consecutive ejection)")
_k("ZOO_EJECT_READMIT_MAX_S", "float", 30.0, "backoff cap")
_k("ZOO_EJECT_ERROR_RATE", "float", 0.6,
   "EWMA error rate that triggers probation on its own")
_k("ZOO_QUARANTINE_PROBE_S", "float", 5.0,
   "quarantine probe-respawn backoff base")
_k("ZOO_QUARANTINE_PROBE_MAX_S", "float", 60.0, "probe backoff cap")
_k("ZOO_QUARANTINE_HEAL_S", "float", 30.0,
   "probe uptime that re-admits the seat")
_k("ZOO_FAULT_SEED", "int", None,
   "deterministic seed for the fault-injection registry's p-draws")
_k("ZOO_HEARTBEAT_FILE", "str", None,
   "per-process heartbeat stamp file (set by the supervisor for every "
   "worker; hung-worker detection reads its age)")
_k("ZOO_HEARTBEAT_INTERVAL", "float", 1.0,
   "heartbeat stamp cadence (seconds)")
_k("ZOO_OBS_SNAPSHOT", "str", None, "metrics JSONL flushed on drain")
_k("ZOO_TRACE_DIR", "str", None, "trace-span JSONL sink directory")
_k("ZOO_OBS_FLIGHT_CAP", "int", 512,
   "flight ring capacity (0 = recorder off)")
_k("ZOO_OBS_POSTMORTEM_DIR", "str", None,
   "bundle dir + arms the continuous spill")
_k("ZOO_SLO_TTFT_P99_S", "float", None,
   "p99 time-to-first-token ceiling (s)")
_k("ZOO_SLO_INTER_TOKEN_P99_S", "float", None,
   "p99 inter-token gap ceiling (s)")
_k("ZOO_SLO_ERROR_RATE", "float", None, "served error-rate ceiling (0..1)")
_k("ZOO_SLO_SHED_RATE", "float", None,
   "admission shed-rate ceiling (0..1)")
_k("ZOO_SLO_TENANT_SHED_RATE", "float", None,
   "per-tenant shed-rate ceiling (0..1) the SLO watchdog evaluates "
   "each window, published as `zoo_tenant_burn_rate`")
_k("ZOO_SLO_KV_UTIL", "float", None,
   "KV-block pool utilization ceiling (0..1)")
_k("ZOO_SLO_SPEC_ACCEPT_FLOOR", "float", None,
   "speculative accept-rate FLOOR (0..1)")
_k("ZOO_SLO_WINDOW_S", "float", 60.0, "rolling evaluation window (s)")
_k("ZOO_SLO_INTERVAL_S", "float", 5.0, "evaluation period (s)")
_k("ZOO_SLO_FAIL_HEALTHZ", "bool", False,
   "1 = an active breach turns `/healthz` 503")
_k("ZOO_CHAOS_SPEC", "str", "",
   "the storm's fault schedule (`kind@T[:k=v,...]`, `;`-separated)")
_k("ZOO_CHAOS_SEED", "int", 0, "seed resolving every draw in the schedule")
_k("ZOO_CHAOS_ALLOW", "bool", False,
   "`1` lets a replica honor wire `chaos` ops")


def get(name: str) -> Knob:
    try:
        return KNOBS[name]
    except KeyError:
        raise KeyError(f"{name} is not a knob of zoo_tpu_torch") from None


def value(name: str, env=None):
    """Parse knob ``name`` from the environment (see :meth:`Knob.read`)."""
    return get(name).read(env)
