"""The telemetry catalog: every ``zoo_*`` metric family and every
flight-ring event kind, declared in one place (counterpart of
``zoo_tpu/obs/catalog.py``, whole: both packages publish the same
families, so one catalog names them).

A ``counter/gauge/histogram`` creation site in the package whose name
is not declared here is a typo waiting to split a time series; a
creation site whose labels disagree with the declaration is a
label-cardinality bomb or a silent join break. Flight-ring event kinds
(:func:`zoo_tpu_torch.obs.flight.record_event`) follow the same rules.
``tests/test_torch_obs.py`` holds the package's creation sites to it.

Label VALUES are deliberately not declared — they are bounded at the
call sites; the label *names* here are what the aggregator joins on.

Stdlib only.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Tuple

__all__ = ["METRICS", "EVENT_KINDS"]

#: name -> (kind, label names). Kind is ``counter`` / ``gauge`` /
#: ``histogram`` exactly as created against the
#: :class:`zoo_tpu_torch.obs.metrics.MetricsRegistry`.
METRICS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    # -- resilience (retry / breaker / fault injection) ---------------------
    "zoo_retry_attempts_total": ("counter", ()),
    "zoo_retry_giveups_total": ("counter", ()),
    "zoo_breaker_transitions_total": ("counter", ("state",)),
    "zoo_breaker_open": ("gauge", ()),
    "zoo_fault_injections_total": ("counter", ("site",)),
    # -- checkpointing ------------------------------------------------------
    "zoo_ckpt_save_seconds": ("histogram", ()),
    "zoo_ckpt_restore_seconds": ("histogram", ()),
    "zoo_ckpt_verify_seconds": ("histogram", ()),
    "zoo_ckpt_quarantined_total": ("counter", ()),
    # -- training guard -----------------------------------------------------
    "zoo_guard_nonfinite_steps_total": ("counter", ()),
    "zoo_guard_rollbacks_total": ("counter", ()),
    "zoo_guard_preempt_checkpoints_total": ("counter", ()),
    "zoo_guard_diverged_total": ("counter", ()),
    "zoo_guard_rolling_loss": ("gauge", ()),
    # -- worker supervision -------------------------------------------------
    "zoo_worker_restarts_total": ("counter", ()),
    "zoo_worker_hung_total": ("counter", ()),
    "zoo_worker_quarantine_total": ("counter", ("event",)),
    # -- data plane ---------------------------------------------------------
    "zoo_shard_fetch_seconds": ("histogram", ()),
    "zoo_shard_fetch_bytes_total": ("counter", ()),
    "zoo_shard_fetch_requests_total": ("counter", ("mode",)),
    "zoo_shard_pool_connections_total": ("counter", ("event",)),
    "zoo_shard_lane_total": ("counter", ("lane",)),
    "zoo_shard_lane_bytes_total": ("counter", ("lane",)),
    "zoo_shard_wire_saved_bytes_total": ("counter", ()),
    "zoo_shard_pipeline_stage_seconds": ("histogram", ("stage",)),
    "zoo_shard_readahead": ("gauge", ("knob",)),
    "zoo_rebalance_barrier_wait_seconds": ("histogram", ("phase",)),
    # -- wire integrity -----------------------------------------------------
    "zoo_wire_corrupt_frames_total": ("counter", ("plane",)),
    # -- step profiling / mesh ---------------------------------------------
    "zoo_step_phase_seconds": ("histogram", ("phase",)),
    "zoo_mesh_axis_size": ("gauge", ("axis",)),
    "zoo_mesh_collective_bytes_total": ("counter", ("op",)),
    # -- serving (single server) -------------------------------------------
    "zoo_serving_queue_depth": ("gauge", ()),
    "zoo_serving_batch_occupancy": ("histogram", ()),
    "zoo_serving_stage_seconds": ("histogram", ("stage",)),
    "zoo_serving_requests_total": ("counter", ("outcome",)),
    "zoo_serve_shed_total": ("counter", ("reason",)),
    "zoo_serve_deadline_expired_total": ("counter", ("stage",)),
    "zoo_serve_dedup_total": ("counter", ("kind",)),
    "zoo_serve_reload_total": ("counter", ("outcome",)),
    "zoo_serve_drain_seconds": ("histogram", ()),
    "zoo_registry_version_info": ("gauge", ("version",)),
    "zoo_quant_path_info": ("gauge", ("path", "speedup")),
    # -- serving HA (replica group / client) -------------------------------
    "zoo_serve_replicas_healthy": ("gauge", ()),
    "zoo_serve_replica_restarts": ("gauge", ()),
    "zoo_serve_replicas_quarantined": ("gauge", ()),
    "zoo_serve_rolling_update_total": ("counter", ("outcome",)),
    "zoo_serve_rolling_update_seconds": ("histogram", ()),
    "zoo_serve_hedge_total": ("counter", ("event",)),
    "zoo_serve_failover_total": ("counter", ()),
    "zoo_serve_client_attempt_seconds": ("histogram", ()),
    "zoo_serve_ab_requests_total": ("counter", ("version", "outcome")),
    "zoo_serve_ab_latency_seconds": ("histogram", ("version",)),
    # -- gray-failure ejection ---------------------------------------------
    "zoo_serve_ejections_total": ("counter", ("event",)),
    "zoo_serve_replicas_ejected": ("gauge", ()),
    "zoo_serve_replicas_probation": ("gauge", ()),
    # -- model registry / promotion ----------------------------------------
    "zoo_registry_publish_total": ("counter", ("outcome",)),
    "zoo_registry_quarantined_total": ("counter", ()),
    "zoo_registry_gc_removed_total": ("counter", ()),
    "zoo_registry_versions": ("gauge", ()),
    "zoo_promotion_total": ("counter", ("outcome",)),
    "zoo_promotion_canary_error_rate": ("gauge", ()),
    "zoo_promotion_canary_latency_ratio": ("gauge", ()),
    "zoo_promotion_canary_loss_ratio": ("gauge", ()),
    # -- LLM engine ---------------------------------------------------------
    "zoo_llm_tokens_total": ("counter", ("kind",)),
    "zoo_llm_decode_steps_total": ("counter", ()),
    "zoo_llm_ttft_seconds": ("histogram", ()),
    "zoo_llm_inter_token_seconds": ("histogram", ()),
    "zoo_llm_stream_ttft_seconds": ("histogram", ("outcome",)),
    "zoo_llm_slot_occupancy": ("gauge", ()),
    "zoo_llm_waiting_streams": ("gauge", ()),
    "zoo_llm_preempt_total": ("counter", ()),
    "zoo_llm_streams_total": ("counter", ("outcome",)),
    "zoo_llm_stream_dedup_total": ("counter", ()),
    "zoo_llm_tick_seconds": ("histogram", ("phase",)),
    "zoo_llm_tick_overlap_ratio": ("gauge", ()),
    "zoo_llm_kv_blocks_used": ("gauge", ()),
    "zoo_llm_kv_blocks_free": ("gauge", ()),
    "zoo_llm_kv_blocks_shared": ("gauge", ()),
    "zoo_llm_kv_blocks_cached": ("gauge", ()),
    "zoo_llm_kv_bytes_per_token": ("gauge", ()),
    "zoo_llm_prefix_cache_hit_tokens_total": ("counter", ()),
    "zoo_llm_prefix_cache_miss_tokens_total": ("counter", ()),
    "zoo_llm_host_transfer_bytes_total": ("counter", ("kind",)),
    "zoo_llm_spec_proposed_tokens_total": ("counter", ()),
    "zoo_llm_spec_accepted_tokens_total": ("counter", ()),
    "zoo_llm_spec_accept_len": ("histogram", ()),
    "zoo_llm_spec_draft_hit_rate": ("gauge", ()),
    # -- disaggregated serving (prefill/decode pools + kv_migrate) ----------
    "zoo_llm_kv_migrated_blocks_total": ("counter", ()),
    "zoo_llm_kv_migrated_bytes_total": ("counter", ()),
    "zoo_llm_handoff_seconds": ("histogram", ()),
    "zoo_serve_route_affinity_total": ("counter", ("reason",)),
    # -- multi-tenant QoS ---------------------------------------------------
    "zoo_tenant_admitted_total": ("counter", ("tenant",)),
    "zoo_tenant_shed_total": ("counter", ("tenant", "reason")),
    "zoo_tenant_preempted_total": ("counter", ("tenant", "reason")),
    "zoo_tenant_kv_blocks": ("gauge", ("tenant",)),
    "zoo_tenant_decode_slots": ("gauge", ("tenant",)),
    "zoo_tenant_kv_cross_evictions_total": ("counter", ("tenant",)),
    "zoo_tenant_burn_rate": ("gauge", ("tenant", "slo")),
    # -- flight recorder / SLO watchdog ------------------------------------
    "zoo_flight_events_total": ("counter", ("kind",)),
    "zoo_flight_dumps_total": ("counter", ("reason",)),
    "zoo_slo_burn_rate": ("gauge", ("slo",)),
    "zoo_slo_breach": ("gauge", ("slo",)),
    "zoo_slo_rules_armed": ("gauge", ()),
}

#: every structured event kind fed to the crash flight recorder
#: (:func:`zoo_tpu_torch.obs.flight.record_event` / ``FlightRecorder.record``)
EVENT_KINDS: FrozenSet[str] = frozenset({
    "replica_boot",
    "shed",
    "tenant_shed",
    "drain",
    "engine_tick",
    "llm_preempt",
    "llm_stream_end",
    "frame_corrupt",
    "corrupt_request_dropped",
    "chaos_arm",
    "chaos_clear",
    "kv_migrate_out",
    "kv_migrate_in",
    "kv_handoff_abort",
    "slo_breach",
    "slo_clear",
    "preempt_exit",
    "fatal_signal",
    "unhandled_exception",
})
