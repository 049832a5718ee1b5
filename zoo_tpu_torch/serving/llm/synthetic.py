"""Deterministic LLM stand-in for chaos smokes and benches (counterpart
of ``zoo_tpu/serving/llm/synthetic.py``, whole; host only, no kernel).

The same role ``synthetic:double`` plays for the predict path, for the
streaming ``generate`` path: a
:class:`SyntheticLLMModel` exposes the full ``PagedLlamaModel``
scheduling surface — prefill / chunked prefill / decode / the async
``decode_step`` overlap API — over a **pure token function**, so a
whole :class:`~zoo_tpu_torch.serving.llm.engine.LLMEngine` (real block
allocator, real continuous batching, real deadlines/preemption/dedup)
boots in milliseconds with no device. Spec form::

    synthllm:slots=2,block=4,blocks=64,tables=8,max_prompt=64

mounted by ``zoo_tpu_torch.serving.replica`` exactly like ``llama:*``
specs; combine with a predict model on one replica as
``synthetic:double:2+synthllm:slots=2`` for mixed-op chaos storms.

Determinism is the load-bearing property: greedy next token =
``(2*tok + pos) % 97`` and seeded sampling = ``(31*seed + 7*pos +
3*tok) % 97`` are pure functions of (last token, position[, seed]), so
*every* replica of a group generates bit-identical streams —
failover-with-resume mid-SIGKILL is verifiable byte-for-byte against
:func:`reference` computed locally by the test. (These are the exact
functions the engine's fake-model unit suite proves the scheduler
against; packaged here so supervised replica PROCESSES can serve
them.)

``fault_point("llm.decode")`` / ``fault_point("llm.prefill")`` mark
every model call: the wire ``chaos`` op can arm a per-tick delay to
turn one replica gray-slow (20x inter-token latency with a perfectly
healthy /healthz), the failure mode the ejection layer exists for.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from zoo_tpu_torch.util.resilience import fault_point

__all__ = ["SyntheticLLMModel", "reference", "next_token"]


def next_token(tok: int, pos: int, temp: float = 0.0,
               seed: int = 0) -> int:
    """The pure token function (greedy, or seeded when ``temp > 0``)."""
    if temp > 0:
        return (31 * int(seed) + 7 * int(pos) + 3 * int(tok)) % 97
    return (2 * int(tok) + int(pos)) % 97


def reference(prompt: Sequence[int], n: int, temp: float = 0.0,
              seed: int = 0) -> List[int]:
    """What any correct schedule — continuous, preempted, failed-over,
    chaos-ridden — must emit for ``prompt``: the fault-free oracle."""
    seq = list(int(t) for t in prompt)
    out: List[int] = []
    for _ in range(n):
        out.append(next_token(seq[-1], len(seq), temp, seed))
        seq.append(out[-1])
    return out


class SyntheticLLMModel:
    """The ``PagedLlamaModel`` surface over :func:`next_token`."""

    def __init__(self, num_slots: int = 2, block_size: int = 4,
                 num_blocks: int = 64, max_blocks_per_seq: int = 8,
                 max_prompt_len: int = 48, eos_id: Optional[int] = None,
                 prefill_chunk: int = 0):
        self.num_slots = int(num_slots)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.max_context = self.block_size * self.max_blocks_per_seq
        self.max_prompt_len = int(max_prompt_len)
        self.prefill_chunk_size = int(prefill_chunk)
        self.eos_id = eos_id

    @staticmethod
    def _sampling(sampling):
        t, _, _, s = sampling or (0.0, 0, 1.0, 0)
        return t, s

    def prefill(self, prompt, block_table_row, sampling=None):
        fault_point("llm.prefill", n=len(prompt))
        t, s = self._sampling(sampling)
        return next_token(prompt[-1], len(prompt), t, s)

    def prefill_chunk(self, chunk, start, total_len, block_table_row,
                      sampling=None):
        fault_point("llm.prefill", n=len(chunk))
        t, s = self._sampling(sampling)
        # only the final chunk's return value is consumed (it carries
        # the prompt's last token)
        return next_token(chunk[-1], total_len, t, s)

    def decode(self, tokens, block_tables, positions, sampling=None):
        fault_point("llm.decode", n=len(tokens))
        if sampling is None:
            temps = seeds = [0] * len(tokens)
        else:
            temps, _, _, seeds = sampling
        # positions[i] is the cache index the incoming token lands at,
        # so the sequence is position + 1 tokens long once written —
        # the same length prefill sees, which makes preemption's
        # re-prefill (and failover's resume) seamless
        return np.array(
            [next_token(t, p + 1, tt, s)
             for t, p, tt, s in zip(tokens, positions, temps, seeds)],
            np.int32)

    # the async dispatch surface the overlapped tick pipeline drives;
    # the fake "device" is synchronous so the batch IS the array
    def decode_step(self, prev, host_tokens, use_host, block_tables,
                    positions, sampling):
        prev = np.zeros_like(host_tokens) if prev is None else \
            np.asarray(prev)
        toks = np.where(np.asarray(use_host), host_tokens, prev)
        return self.decode(toks, block_tables, positions, sampling)

    def read_tokens(self, batch):
        return np.asarray(batch)
