"""Prefill/decode split over one set of Llama weights, paged KV
(counterpart of ``zoo_tpu/serving/llm/model.py``).

* **Prefill** — a causal forward over the padded prompt, one shape per
  prompt-length bucket (32/128/512 by default). Attention goes through
  :func:`~zoo_tpu_torch.ops.attention.dot_product_attention`: the flash
  kernel from 512 tokens up on a CUDA device, the dense path otherwise.
  The prompt's K/V are written into the paged cache through the
  sequence's block table. With ``prefill_chunk=N`` prompts are fed in
  N-token chunks that attend over everything already in the cache
  (the paged-prefill kernel).
* **Decode** — ``num_slots`` sequences x 1 token per tick: write the
  incoming token's K/V through the block tables, run paged attention
  over the cache (the paged-decode kernel), and sample the next token
  on the device. Only ``slots x 1`` int32 ids cross to the host.
* **Verify** (``spec_k > 0``, speculative decoding) — ``num_slots``
  sequences x ``spec_k + 1`` candidate rows per pass: each row's K/V is
  written at its own position, the rows attend through the paged-prefill
  kernel, and each row samples the token plain decode would draw there.
  Only ``slots x (spec_k + 1)`` int32 ids cross to the host.

Each attention has two implementations: ``"flash"`` (the CUDA kernel,
the default on a CUDA device) and ``"dense"`` (the plain PyTorch
gather, the default on the CPU and the reference the kernels are held
against). Inactive slots point their table at the reserved trash block
0 and are masked by position, so a tick never branches on liveness.

The cache is one dict of tensors ``{k, v[, ks, vs]}`` of shape
``(n_layer, num_blocks, block_size, n_kv_head, head_dim)`` (int8 scales
without the last axis), **written in place**: the JAX package donates
the cache to each executable so XLA aliases it; here the same tensors
are updated with indexed assignment.

A decode tick's or verify pass's ids are returned as a
:class:`TokenBatch`; a decode tick's is accepted back by the next tick,
so back-to-back ticks chain on the device; only
:meth:`PagedLlamaModel.read_tokens` waits for the device. Per-tick host
inputs (tokens, tables, positions, sampling lanes) travel in one packed
int32 buffer, copied without a host sync.
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from zoo_tpu_torch.common.device import resolve_device
from zoo_tpu_torch.common.knobs import value as knob_value
from zoo_tpu_torch.models.llm.llama import (
    BLOCK_KEYS,
    Llama,
    LlamaConfig,
    apply_rope,
    resolve_attention_impl,
    rms_norm,
    rope_frequencies,
)
from zoo_tpu_torch.ops.attention import dot_product_attention
from zoo_tpu_torch.ops.kernels.paged_decode import (
    paged_decode_plain,
    paged_flash_decode,
)
from zoo_tpu_torch.ops.kernels.paged_prefill import (
    paged_flash_prefill,
    paged_prefill_plain,
)
from zoo_tpu_torch.ops.random import M32 as _M32
from zoo_tpu_torch.ops.random import threefry_bits
from zoo_tpu_torch.util.quantize import absmax_scale, narrow_int8

DEFAULT_PREFILL_BUCKETS = (32, 128, 512)

# chunk width used to feed the uncached suffix of a prefix-cache hit
# when chunked prefill is off (the bucket path can only start at 0)
SUFFIX_CHUNK_DEFAULT = 64

KV_DTYPES = ("f32", "bf16", "int8")
_KV_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16,
             "int8": torch.int8}


def _resolve_impl(impl, knob, what, device) -> str:
    if impl in (None, "auto"):
        impl = knob_value(knob) or "auto"
    if impl == "auto":
        from zoo_tpu_torch.ops.kernels import on_cuda
        return "flash" if on_cuda(device) else "dense"
    if impl not in ("dense", "flash"):
        raise ValueError(f"unknown {what} impl {impl!r} "
                         "(dense / flash / auto)")
    return impl


def resolve_decode_impl(impl: Optional[str] = "auto", device=None) -> str:
    """Decode attention for ``device``: ``auto`` picks the paged-decode
    kernel on a CUDA device and the dense gather on the CPU;
    ``ZOO_LLM_DECODE_IMPL`` overrides auto."""
    return _resolve_impl(impl, "ZOO_LLM_DECODE_IMPL", "decode", device)


def resolve_prefill_impl(impl: Optional[str] = "auto", device=None) -> str:
    """Chunk-prefill attention, as :func:`resolve_decode_impl`
    (``ZOO_LLM_PREFILL_IMPL``). The bucketed whole-prompt prefill uses
    :func:`~zoo_tpu_torch.models.llm.llama.resolve_attention_impl`."""
    return _resolve_impl(impl, "ZOO_LLM_PREFILL_IMPL", "prefill", device)


def resolve_kv_dtype(dtype: Optional[str] = None, device=None) -> str:
    """KV cache dtype: ``None`` reads ``ZOO_LLM_KV_DTYPE`` (default
    f32); ``auto`` picks int8 on a CUDA device (decode reads the cache
    from device memory every tick) and f32 on the CPU."""
    if dtype in (None, ""):
        dtype = knob_value("ZOO_LLM_KV_DTYPE") or "f32"
    dtype = {"fp32": "f32", "float32": "f32",
             "bfloat16": "bf16"}.get(dtype, dtype)
    if dtype == "auto":
        from zoo_tpu_torch.ops.kernels import on_cuda
        return "int8" if on_cuda(device) else "f32"
    if dtype not in KV_DTYPES:
        raise ValueError(f"unknown KV cache dtype {dtype!r} "
                         f"({'/'.join(KV_DTYPES)}/auto)")
    return dtype


def _pick_bucket(buckets: Sequence[int], n: int) -> Optional[int]:
    for b in buckets:
        if n <= b:
            return b
    return None


# ------------------------------------------------------ on-device sampling

GREEDY = (0.0, 0, 1.0, 0)  # (temperature, top_k, top_p, seed)
_F32_TINY = float(torch.finfo(torch.float32).tiny)


def gumbel_noise(seeds: torch.Tensor, token_index: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """(N, vocab) f32 Gumbel noise keyed by ``(seed, token_index)`` per
    row, bit for bit JAX's ``gumbel(fold_in([0, seed], token_index),
    (vocab,))`` (``zoo_tpu/serving/llm/model.py`` ``_slot_keys``) up to
    the last ulp of ``log``: the draw depends only on the stream's seed
    and the token's position, never on scheduling history, so a
    preempted stream resumed on any replica, of either package, redraws
    the same tokens. The uniform is JAX's: the top 23 bits as the
    mantissa of a float in [1, 2), minus 1, floored at the smallest
    normal float (``(maxval - minval)`` rounds to 1 in f32, and adding
    ``tiny`` moves only a zero)."""
    bits = threefry_bits(seeds, token_index, vocab)
    f = bits.bitwise_right_shift_(9).bitwise_or_(0x3F800000).to(
        torch.int32).view(torch.float32) - 1.0
    return -torch.log(-torch.log(f.clamp_min_(_F32_TINY)))


def _sample_rows(logits, temps, topks, topps, noise) -> torch.Tensor:
    """(N, vocab) logits -> (N,) int32 ids, lanes independent, in the
    JAX ``_sample_one`` order: temperature, top-k, top-p nucleus, then
    Gumbel-max with the given ``noise``; ``temp <= 0`` is argmax."""
    v = logits.shape[-1]
    logits = logits.float()
    greedy = logits.argmax(dim=-1)
    scaled = logits / temps.clamp_min(1e-4)[:, None]
    desc = scaled.sort(dim=-1, descending=True).values
    kth = desc.gather(1, (topks.long().clamp(1, v) - 1)[:, None])
    neg_inf = torch.full_like(scaled, -math.inf)
    masked = torch.where((topks <= 0)[:, None] | (scaled >= kth), scaled,
                         neg_inf)
    probs = torch.softmax(masked, dim=-1)
    sp = probs.sort(dim=-1, descending=True).values
    # nucleus: a token is in it iff the mass STRICTLY BEFORE it is < topp
    included = (sp.cumsum(dim=-1) - sp) < topps[:, None]
    thresh = torch.where(included, sp, torch.full_like(sp, math.inf)) \
        .amin(dim=-1, keepdim=True)
    masked = torch.where(probs >= thresh, masked, neg_inf)
    sampled = (masked + noise).argmax(dim=-1)
    return torch.where(temps <= 0, greedy, sampled).to(torch.int32)


def _sample_one(logits, temp, topk, topp, noise) -> torch.Tensor:
    """Sample ONE id from a (vocab,) logit row with the given (vocab,)
    Gumbel ``noise`` (the row form of :func:`_sample_rows`)."""
    dev = logits.device
    return _sample_rows(
        logits[None], torch.tensor([float(temp)], device=dev),
        torch.tensor([int(topk)], device=dev),
        torch.tensor([float(topp)], device=dev), noise[None])[0]


class TokenBatch:
    """One dispatched tick's (S,) or verify pass's (S, spec_k + 1) int32
    ids: ``dev`` chains into the next decode tick; ``host`` (pinned, of
    ``dev``'s shape) receives a copy ordered after the pass, and
    ``event`` marks when it has landed."""

    __slots__ = ("dev", "host", "event")

    def __init__(self, dev, host, event):
        self.dev, self.host, self.event = dev, host, event


def _rope_rows(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate (..., H, D) by per-ROW angles (..., D/2): the decode and
    chunk variant of :func:`apply_rope`, each row at its own position."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


class PagedLlamaModel:
    """Llama weights + paged KV cache + the serving paths.

    ``params=None`` draws the weights from ``seed`` (:meth:`Llama.from_seed`);
    otherwise ``params`` is a parameter tree in the JAX layout (e.g. from
    :func:`zoo_tpu_torch.convert.params_from_jax`, or another model's
    ``params`` to share one set of weights). ``device=None`` is the
    current CUDA device; pass ``device="cpu"`` for the plain path.
    ``attention_impl`` selects the bucket-prefill attention
    (``auto``/``dense``/``flash``) as ``decode_impl``/``prefill_impl``
    select the paged paths (``prefill_impl`` also the verify pass's).
    ``spec_k`` is the verify pass's draft width (``None`` reads
    ``ZOO_LLM_SPEC_K``; 0 = no verify path)."""

    def __init__(self, config: LlamaConfig, *,
                 params=None, seed: int = 0,
                 num_slots: int = 8,
                 block_size: int = 16,
                 num_blocks: int = 128,
                 max_blocks_per_seq: int = 32,
                 prefill_buckets: Sequence[int] = DEFAULT_PREFILL_BUCKETS,
                 prefill_chunk: Optional[int] = None,
                 decode_impl: str = "auto",
                 prefill_impl: str = "auto",
                 attention_impl: str = "auto",
                 kv_dtype: Optional[str] = None,
                 spec_k: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = config
        c = config
        self.num_slots = int(num_slots)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.prefill_buckets = tuple(sorted(int(b) for b in
                                            prefill_buckets))
        if prefill_chunk is None:
            prefill_chunk = int(knob_value("ZOO_LLM_PREFILL_CHUNK"))
        self.prefill_chunk_size = int(prefill_chunk)
        if self.prefill_chunk_size < 0:
            raise ValueError("prefill_chunk must be >= 0 (0 = off)")
        # the verify pass scores spec_k + 1 rows a slot: the incoming
        # token and up to spec_k drafted ones; 0 = plain decode only
        if spec_k is None:
            spec_k = int(knob_value("ZOO_LLM_SPEC_K"))
        self.spec_k = int(spec_k)
        if self.spec_k < 0:
            raise ValueError("spec_k must be >= 0 (0 = off)")
        self.decode_attention_impl = resolve_decode_impl(decode_impl,
                                                         self.device)
        self.prefill_attention_impl = resolve_prefill_impl(prefill_impl,
                                                           self.device)
        self.attention_impl = attention_impl
        if self.device.type != "cuda" and "flash" in (
                self.decode_attention_impl, self.prefill_attention_impl,
                attention_impl):
            raise ValueError("the flash attention kernels run on a CUDA "
                             f"device, not {self.device}; use 'dense'")
        self.kv_cache_dtype_requested = kv_dtype if kv_dtype not in (
            None, "") else (knob_value("ZOO_LLM_KV_DTYPE") or "f32")
        self.kv_cache_dtype = resolve_kv_dtype(kv_dtype, self.device)
        # bytes ONE cached token costs (K+V rows over every layer, plus
        # the scale rows for int8): the zoo_llm_kv_bytes_per_token gauge
        item = {"f32": 4, "bf16": 2, "int8": 1}[self.kv_cache_dtype]
        self.kv_bytes_per_token = (
            2 * c.n_block * c.n_kv_head * c.head_dim * item
            + (2 * c.n_block * c.n_kv_head * 4
               if self.kv_cache_dtype == "int8" else 0))
        self.eos_id = eos_id
        if self.num_slots < 1 or self.num_blocks < 2:
            raise ValueError("need >= 1 slot and >= 2 KV blocks")
        self.max_context = self.max_blocks_per_seq * self.block_size
        if self.prefill_buckets[-1] > self.max_context:
            raise ValueError(
                f"largest prefill bucket {self.prefill_buckets[-1]} "
                f"exceeds the block-table context capacity "
                f"{self.max_context}")
        self.max_prompt_len = self.prefill_buckets[-1] \
            if not self.prefill_chunk_size else self.max_context

        if params is None:
            params = Llama.from_seed(c, seed=seed, device=self.device).params
        self.params = {
            "embed": params["embed"].to(self.device),
            "blocks": {k: params["blocks"][k].to(self.device)
                       for k in BLOCK_KEYS},
            "final_norm": params["final_norm"].to(self.device)}
        if not c.tie_embeddings:
            self.params["head"] = params["head"].to(self.device)
        self._cos, self._sin = rope_frequencies(
            c.head_dim, self.max_context, c.rope_theta, self.device)
        self._scale = 1.0 / math.sqrt(c.head_dim)
        shape = (c.n_block, self.num_blocks, self.block_size,
                 c.n_kv_head, c.head_dim)
        dt = _KV_TORCH[self.kv_cache_dtype]
        self._cache = {"k": torch.zeros(shape, dtype=dt, device=self.device),
                       "v": torch.zeros(shape, dtype=dt, device=self.device)}
        if self.kv_cache_dtype == "int8":
            # absmax scale per written cache ROW, block-indexed beside
            # the K/V blocks (the block table routes both)
            for name in ("ks", "vs"):
                self._cache[name] = torch.zeros(shape[:-1],
                                                dtype=torch.float32,
                                                device=self.device)
        item = {"f32": 4, "bf16": 2, "int8": 1}[self.kv_cache_dtype]
        self.kv_bytes_per_token = (
            2 * c.n_block * c.n_kv_head * c.head_dim * item
            + (2 * c.n_block * c.n_kv_head * 4
               if self.kv_cache_dtype == "int8" else 0))
        self.suffix_chunk_size = self.prefill_chunk_size or min(
            SUFFIX_CHUNK_DEFAULT, self.prefill_buckets[-1])
        # one dispatch at a time: every path updates the cache in place
        self._lock = threading.Lock()
        self._zero_tokens = torch.zeros((self.num_slots,), dtype=torch.int32,
                                        device=self.device)
        self._calls = {"decode": 0, "prefill": 0, "prefill_chunk": 0,
                       "verify": 0, "copy_block": 0}

    # -- host -> device ----------------------------------------------------
    def _to_device(self, *arrays):
        """Move int32/float32 host arrays to the device in ONE packed
        copy (pinned and asynchronous on CUDA); returns device views
        with the arrays' shapes and dtypes."""
        flat = [np.ascontiguousarray(a).reshape(-1).view(np.int32)
                for a in arrays]
        buf = torch.from_numpy(np.concatenate(flat))
        if self.device.type == "cuda":
            buf = buf.pin_memory().to(self.device, non_blocking=True)
        out, o = [], 0
        for a, f in zip(arrays, flat):
            part = buf[o:o + f.size].view(np.shape(a))
            if np.asarray(a).dtype == np.float32:
                part = part.view(torch.float32)
            out.append(part)
            o += f.size
        return out

    # -- per-layer pieces ----------------------------------------------------
    def _layer(self, i: int):
        return {k: self.params["blocks"][k][i] for k in BLOCK_KEYS}

    def _attn_proj(self, p, x):
        c = self.cfg
        q = (x @ p["wq"]).reshape(*x.shape[:-1], c.n_head, c.head_dim)
        k = (x @ p["wk"]).reshape(*x.shape[:-1], c.n_kv_head, c.head_dim)
        v = (x @ p["wv"]).reshape(*x.shape[:-1], c.n_kv_head, c.head_dim)
        return q, k, v

    def _mlp(self, p, h):
        x = rms_norm(h, p["mlp_norm"], self.cfg.rms_eps)
        return h + (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]

    def _lm_head(self, h):
        c = self.cfg
        h = rms_norm(h, self.params["final_norm"], c.rms_eps)
        head = self.params["embed"].T if c.tie_embeddings \
            else self.params["head"]
        return h @ head.to(h.dtype)

    def _append_rows(self, i: int, name: str, blk, off, x):
        """Write f32 K or V rows ``x`` (N, n_kv, D) of layer ``i`` at
        (blk, off), in place, narrowed per the cache dtype: int8 rows
        store ``clip(round(x / scale))`` with their own absmax scale (a
        row is written once, so bucket, chunk and decode writes of one
        token are the same bytes); bf16 narrows; f32 passes through."""
        cache = self._cache[name][i]
        if self.kv_cache_dtype == "int8":
            s = absmax_scale(x, dim=-1, keepdim=True)
            cache[blk, off] = narrow_int8(x, s)
            self._cache[name + "s"][i][blk, off] = s[..., 0]
        else:
            cache[blk, off] = x.to(cache.dtype)

    def _layer_cache(self, i: int):
        c = self._cache
        if self.kv_cache_dtype == "int8":
            return c["k"][i], c["v"][i], c["ks"][i], c["vs"][i]
        return c["k"][i], c["v"][i], None, None

    def _paged_attend(self, q, i, block_tables, positions):
        """(S, H, D) queries against layer ``i``'s paged cache ->
        (S, H * D): the paged-decode kernel or its plain version."""
        kc, vc, ks, vs = self._layer_cache(i)
        fn = paged_flash_decode if self.decode_attention_impl == "flash" \
            else paged_decode_plain
        out = fn(q, kc, vc, block_tables, positions, k_scale=ks,
                 v_scale=vs, scale=self._scale)
        return out.reshape(q.shape[0], -1)

    def _prefill_attend(self, q, i, block_tables, positions):
        """(B, R, H, D) query rows at cache ``positions`` (B, R) against
        layer ``i``'s paged cache -> (B, R, H * D): the paged-prefill
        kernel or its plain version. The rows' own K/V are already in
        the cache."""
        kc, vc, ks, vs = self._layer_cache(i)
        fn = paged_flash_prefill if self.prefill_attention_impl == "flash" \
            else paged_prefill_plain
        out = fn(q, kc, vc, block_tables, positions, k_scale=ks,
                 v_scale=vs, scale=self._scale)
        return out.reshape(q.shape[0], q.shape[1], -1)

    def _sample_row(self, logits, sampling, token_index: int) -> int:
        t, k, p, s = sampling
        if t <= 0.0:
            return int(logits.argmax())
        dev = logits.device
        noise = gumbel_noise(torch.tensor([s], device=dev),
                             torch.tensor([token_index], device=dev),
                             logits.shape[-1])[0]
        return int(_sample_one(logits, t, k, p, noise))

    # -- the three paths ---------------------------------------------------
    @torch.no_grad()
    def _decode_fn(self, prev, host, use, tables, positions, lanes,
                   sampled: bool):
        c = self.cfg
        bs = self.block_size
        tokens = torch.where(use.bool(), host, prev)
        h = self.params["embed"][tokens.long()]              # (S, hidden)
        pos = positions.long()
        cos, sin = self._cos[pos], self._sin[pos]
        blk = tables.gather(1, (pos // bs)[:, None])[:, 0].long()
        off = pos % bs
        for i in range(c.n_block):
            p = self._layer(i)
            x = rms_norm(h, p["attn_norm"], c.rms_eps)
            q, k, v = self._attn_proj(p, x)
            q = _rope_rows(q, cos, sin)
            k = _rope_rows(k, cos, sin)
            # write this token's K/V, THEN attend: it attends to itself
            self._append_rows(i, "k", blk, off, k)
            self._append_rows(i, "v", blk, off, v)
            o = self._paged_attend(q, i, tables, positions)
            h = h + o @ p["wo"]
            h = self._mlp(p, h)
        logits = self._lm_head(h)                              # (S, vocab)
        greedy = logits.argmax(dim=-1).to(torch.int32)
        if not sampled:
            return greedy
        temps, topks, topps, seeds = lanes
        # the token being drawn sits at sequence index position + 1
        noise = gumbel_noise(seeds, pos + 1, logits.shape[-1])
        return _sample_rows(logits, temps, topks, topps, noise)

    @torch.no_grad()
    def _prefill_fn(self, ids, length: int, blk, off, sampling) -> int:
        c = self.cfg
        L = ids.shape[1]
        cos, sin = self._cos[:L], self._sin[:L]
        impl = resolve_attention_impl(self.attention_impl, L, self.device)
        h = self.params["embed"][ids.long()]                 # (1, L, hidden)
        blk, off = blk.long(), off.long()
        for i in range(c.n_block):
            p = self._layer(i)
            x = rms_norm(h, p["attn_norm"], c.rms_eps)
            q, k, v = self._attn_proj(p, x)                  # (1, L, H, D)
            q = apply_rope(q.transpose(1, 2), cos, sin).contiguous()
            k = apply_rope(k.transpose(1, 2), cos, sin).contiguous()
            v = v.transpose(1, 2).contiguous()
            a = dot_product_attention(q, k, v, causal=True, impl=impl)
            h = h + a.transpose(1, 2).reshape(1, L, -1) @ p["wo"]
            self._append_rows(i, "k", blk, off, k.transpose(1, 2)[0])
            self._append_rows(i, "v", blk, off, v.transpose(1, 2)[0])
            h = self._mlp(p, h)
        # only the last real row's logits are needed; the first
        # generated token is sequence index ``length``
        logits = self._lm_head(h[0, length - 1])
        return self._sample_row(logits, sampling, length)

    @torch.no_grad()
    def _prefill_chunk_fn(self, ids, pos, blk, off, table, last: int,
                          length: int, sampling) -> int:
        c = self.cfg
        cos, sin = self._cos[pos.long()], self._sin[pos.long()]
        h = self.params["embed"][ids.long()]                 # (1, C, hidden)
        blk, off = blk.long(), off.long()
        for i in range(c.n_block):
            p = self._layer(i)
            x = rms_norm(h, p["attn_norm"], c.rms_eps)
            q, k, v = self._attn_proj(p, x)                  # (1, C, H, D)
            q = _rope_rows(q[0], cos, sin)[None]
            k = _rope_rows(k[0], cos, sin)
            self._append_rows(i, "k", blk, off, k)
            self._append_rows(i, "v", blk, off, v[0])
            # causal over the CACHE index space: chunk row r attends
            # every resident position <= its own
            a = self._prefill_attend(q, i, table[None], pos[None])
            h = self._mlp(p, h + a @ p["wo"])
        logits = self._lm_head(h[0, last])
        return self._sample_row(logits, sampling, length)

    @torch.no_grad()
    def _verify_fn(self, tokens, tables, positions, lanes, sampled: bool):
        """Score ``tokens`` (S, T) in one pass: row ``j`` of slot ``s`` is
        written at cache index ``positions[s] + j`` and attends every
        column at or before it, so its logits are what plain decode
        computes after accepting rows ``< j``; it samples with the key
        plain decode uses there, ``(seed, positions[s] + j + 1)``.
        Rejected rows' K/V stay as garbage the position mask hides until
        the next write. Rows past the pageable context take the last
        rope row (a NaN written to the trash block would poison later
        layers) and write to trash block 0; the engine never accepts
        them."""
        c = self.cfg
        bs = self.block_size
        S, T = tokens.shape
        ctx = self.max_context
        raw = positions.long()[:, None] + torch.arange(
            T, device=tokens.device)[None, :]                  # (S, T)
        pos = raw.clamp_max(ctx - 1)
        cos, sin = self._cos[pos], self._sin[pos]              # (S, T, D/2)
        blk = torch.where(raw < ctx, tables.long().gather(1, pos // bs), 0)
        off = pos % bs
        pos32 = pos.to(torch.int32)
        h = self.params["embed"][tokens.long()]               # (S, T, hidden)
        for i in range(c.n_block):
            p = self._layer(i)
            x = rms_norm(h, p["attn_norm"], c.rms_eps)
            q, k, v = self._attn_proj(p, x)                   # (S, T, H, D)
            q = _rope_rows(q, cos, sin)
            k = _rope_rows(k, cos, sin)
            self._append_rows(i, "k", blk, off, k)
            self._append_rows(i, "v", blk, off, v)
            a = self._prefill_attend(q, i, tables, pos32)
            h = self._mlp(p, h + a @ p["wo"])
        logits = self._lm_head(h).reshape(S * T, -1)          # (S*T, vocab)
        if not sampled:
            return logits.argmax(dim=-1).to(torch.int32).reshape(S, T)
        temps, topks, topps, seeds = (x.repeat_interleave(T) for x in lanes)
        noise = gumbel_noise(seeds, (raw + 1).reshape(-1), logits.shape[-1])
        return _sample_rows(logits, temps, topks, topps, noise).reshape(S, T)

    # -- host-facing API (what the engine calls) ---------------------------
    @staticmethod
    def _sampling_tuple(sampling) -> Tuple[float, int, float, int]:
        if sampling is None:
            return GREEDY
        t, k, p, s = sampling
        return float(t), int(k), float(p), int(s) & _M32

    def _table(self, block_table_row) -> np.ndarray:
        bt = np.asarray(block_table_row, np.int32)
        if bt.shape != (self.max_blocks_per_seq,):
            raise ValueError("block_table_row has the wrong width")
        return bt

    def prefill(self, prompt: np.ndarray, block_table_row: np.ndarray,
                sampling=None) -> int:
        """Run one prompt through its bucket; the prompt's K/V land in
        the blocks of ``block_table_row``. Returns the first generated
        token (sampled per ``sampling`` = (temperature, top_k, top_p,
        seed); None = greedy)."""
        n = int(prompt.shape[0])
        bucket = _pick_bucket(self.prefill_buckets, n)
        if bucket is None:
            raise ValueError(
                f"prompt of {n} tokens exceeds the largest prefill "
                f"bucket ({self.prefill_buckets[-1]})")
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :n] = prompt
        bt = self._table(block_table_row)
        pos = np.arange(bucket)
        # pad positions -> trash block 0 (block pos // bs may be
        # unallocated past the prompt's last block)
        blk = np.where(pos < n, bt[pos // self.block_size], 0).astype(
            np.int32)
        off = (pos % self.block_size).astype(np.int32)
        sampling = self._sampling_tuple(sampling)
        with self._lock:
            self._calls["prefill"] += 1
            ids_d, blk_d, off_d = self._to_device(ids, blk, off)
            return self._prefill_fn(ids_d, n, blk_d, off_d, sampling)

    def prefill_chunk(self, chunk: np.ndarray, start: int,
                      total_len: int, block_table_row: np.ndarray,
                      sampling=None) -> int:
        """Feed ONE fixed-width chunk of a prompt (``start`` = offset of
        ``chunk[0]``). Returns the sampled first generated token —
        meaningful only when this chunk holds the prompt's last token."""
        C = self.suffix_chunk_size
        n = int(chunk.shape[0])
        if n < 1 or n > C:
            raise ValueError(f"chunk of {n} tokens (chunk size {C})")
        ids = np.zeros((1, C), np.int32)
        ids[0, :n] = chunk
        bt = self._table(block_table_row)
        ctx = self.max_context
        pos = start + np.arange(C)
        real = pos < total_len
        # pad rows past the context still take a FINITE rope row (a NaN
        # written to the trash block would poison later layers)
        pos = np.minimum(pos, ctx - 1)
        blk = np.where(real, bt[pos // self.block_size], 0).astype(np.int32)
        off = (pos % self.block_size).astype(np.int32)
        last = int(np.clip(total_len - 1 - start, 0, C - 1))
        sampling = self._sampling_tuple(sampling)
        with self._lock:
            self._calls["prefill_chunk"] += 1
            ids_d, pos_d, blk_d, off_d, bt_d = self._to_device(
                ids, pos.astype(np.int32), blk, off, bt)
            return self._prefill_chunk_fn(ids_d, pos_d, blk_d, off_d, bt_d,
                                          last, int(total_len), sampling)

    @torch.no_grad()
    def copy_block(self, src: int, dst: int):
        """Device half of copy-on-write: duplicate block ``src`` into
        ``dst`` (K, V and int8 scale rows, every layer), in place."""
        with self._lock:
            self._calls["copy_block"] += 1
            for arr in self._cache.values():
                arr[:, dst] = arr[:, src]

    # -- KV migration --------------------------------------------------------
    def export_kv_blocks(self, blocks) -> dict:
        """Host copies of the cache rows for ``blocks``, keyed like the
        cache (block axis at position 1, in the order given); bf16 rows
        are exported widened to f32 (exact)."""
        idx = torch.as_tensor(list(blocks), dtype=torch.long,
                              device=self.device)
        with self._lock:
            parts = {name: arr[:, idx] for name, arr in self._cache.items()}
        return {name: (p.float() if p.dtype == torch.bfloat16 else p)
                .cpu().numpy() for name, p in parts.items()}

    @torch.no_grad()
    def import_kv_blocks(self, blocks, data: dict, start: int = 0):
        """Write exported rows ``data[name][:, start:start+len(blocks)]``
        into local ``blocks``, in place."""
        blocks = list(blocks)
        if not blocks:
            return
        missing = set(self._cache) - set(data)
        if missing:
            raise ValueError(
                f"kv payload is missing cache planes {sorted(missing)} "
                f"(this cache is {self.kv_cache_dtype})")
        idx = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
        stop = start + len(blocks)
        with self._lock:
            for name, arr in self._cache.items():
                rows = torch.from_numpy(np.array(
                    np.asarray(data[name])[:, start:stop])).to(
                    self.device, arr.dtype)
                arr[:, idx] = rows

    def decode_step(self, prev_batch: Optional[TokenBatch],
                    host_tokens: np.ndarray, use_host: np.ndarray,
                    block_tables: np.ndarray, positions: np.ndarray,
                    sampling_lanes) -> TokenBatch:
        """Dispatch ONE continuous-batching tick WITHOUT a host sync:
        returns the tick's :class:`TokenBatch`, which the next tick
        accepts back as ``prev_batch`` (lanes whose ``use_host`` is set
        take ``host_tokens`` instead: fresh admissions).
        ``sampling_lanes`` = (temps, topks, topps, seeds), one lane per
        slot; a greedy-only tick (every temperature <= 0, decided here
        on the host) skips the sampling pipeline."""
        temps, topks, topps, seeds = sampling_lanes
        temps = np.asarray(temps, np.float32)
        sampled = bool((temps > 0.0).any())
        with self._lock:
            self._calls["decode"] += 1
            host, use, tables, pos, tk, sd, tp, tpp = self._to_device(
                np.asarray(host_tokens, np.int32),
                np.asarray(use_host, np.int32),
                np.asarray(block_tables, np.int32),
                np.asarray(positions, np.int32),
                np.asarray(topks, np.int32),
                np.asarray(seeds, np.uint32).view(np.int32),
                temps, np.asarray(topps, np.float32))
            prev = self._zero_tokens if prev_batch is None \
                else prev_batch.dev
            return self._token_batch(self._decode_fn(
                prev, host, use, tables, pos, (tp, tk, tpp, sd), sampled))

    def verify_step(self, tokens: np.ndarray, block_tables: np.ndarray,
                    positions: np.ndarray, sampling_lanes) -> TokenBatch:
        """Dispatch ONE speculative verify pass WITHOUT a host sync:
        ``tokens`` (num_slots, spec_k + 1), row 0 the slot's incoming
        token and rows 1.. its drafted continuation (zero-padded),
        written from each slot's ``positions`` entry on. Returns the
        pass's :class:`TokenBatch` of (num_slots, spec_k + 1) canonical
        ids; the engine emits the longest accepted prefix. One fixed
        shape; a greedy-only pass skips the sampling pipeline."""
        tokens = np.asarray(tokens, np.int32)
        if self.spec_k < 1:
            raise RuntimeError("verify_step needs spec_k >= 1 at model "
                               "construction")
        if tokens.shape != (self.num_slots, self.spec_k + 1):
            raise ValueError(
                f"verify batch {tokens.shape} != the fixed "
                f"{(self.num_slots, self.spec_k + 1)} census shape")
        temps, topks, topps, seeds = sampling_lanes
        temps = np.asarray(temps, np.float32)
        sampled = bool((temps > 0.0).any())
        with self._lock:
            self._calls["verify"] += 1
            toks, tables, pos, tk, sd, tp, tpp = self._to_device(
                tokens, np.asarray(block_tables, np.int32),
                np.asarray(positions, np.int32),
                np.asarray(topks, np.int32),
                np.asarray(seeds, np.uint32).view(np.int32),
                temps, np.asarray(topps, np.float32))
            return self._token_batch(self._verify_fn(
                toks, tables, pos, (tp, tk, tpp, sd), sampled))

    def _token_batch(self, out: torch.Tensor) -> TokenBatch:
        """Wrap a dispatched pass's ids, with a pinned host copy ordered
        after it on a CUDA device."""
        if self.device.type != "cuda":
            return TokenBatch(out, out, None)
        host_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host_out.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return TokenBatch(out, host_out, event)

    def read_tokens(self, batch: TokenBatch) -> np.ndarray:
        """Block until a dispatched pass's ids are on the host: the ONLY
        device -> host transfer of the decode and verify paths (slots x
        1, or slots x (spec_k + 1), int32; never logits)."""
        if batch.event is not None:
            batch.event.synchronize()
        return batch.host.numpy().copy()

    def decode(self, tokens: np.ndarray, block_tables: np.ndarray,
               positions: np.ndarray, sampling_lanes=None) -> np.ndarray:
        """Synchronous decode tick: every slot's incoming token comes
        from the host and the sampled batch is read straight back."""
        S = self.num_slots
        if sampling_lanes is None:
            sampling_lanes = (np.zeros(S, np.float32), np.zeros(S, np.int32),
                              np.ones(S, np.float32), np.zeros(S, np.uint32))
        batch = self.decode_step(None, tokens, np.ones(S, bool),
                                 block_tables, positions, sampling_lanes)
        return self.read_tokens(batch)

    def compile_counts(self) -> dict:
        """Calls per path. PyTorch runs eagerly and compiles nothing;
        the JAX package's census of executables becomes this count."""
        return dict(self._calls)
