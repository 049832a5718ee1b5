"""Model-free n-gram (prompt-lookup) drafter for speculative decoding
(counterpart of ``zoo_tpu/serving/llm/speculative.py``).

A decode tick streams every weight once for one token a slot. With
speculation the drafter proposes up to ``k`` continuation tokens, one
verify pass scores all of them
(:meth:`~zoo_tpu_torch.serving.llm.model.PagedLlamaModel.verify_step`),
and the engine emits the longest accepted prefix plus the model's own
next token: up to ``k + 1`` tokens for one pass over the weights.

The drafter guesses "what followed the last time these tokens
appeared": the last ``n`` tokens of prompt + generated history (``n``
from ``ngram_max`` down to 1, longer matches first), their most recent
earlier occurrence, and the ``k`` tokens that followed it. A wrong guess
costs only its verify row; the accept step keeps the stream
byte-identical to plain decode.

Pure numpy: the engine drafts on the scheduler thread.
"""

from __future__ import annotations

import numpy as np

_EMPTY = np.zeros((0,), np.int32)


def _continuation(start: int, n: int, L: int, k: int) -> np.ndarray:
    """Context indices of the ``k`` tokens after an ``n``-gram match at
    ``start`` in a context of ``L`` tokens: past the end, the period
    ``(L - n) - start`` the match implies is extrapolated."""
    period = (L - n) - start
    idx = start + n + np.arange(int(k))
    over = idx >= L
    if over.any():
        idx[over] = L - period + (idx[over] - L) % period
    return idx


def propose_tokens(context, k: int, ngram_max: int = 3) -> np.ndarray:
    """Up to ``k`` draft tokens continuing ``context`` (1-D ints: prompt
    + everything generated, ending with the last emitted token). The
    longest suffix n-gram (``ngram_max`` down to 1) that re-occurs
    earlier wins, at its most recent occurrence; empty when the context
    never repeats."""
    if k <= 0:
        return _EMPTY
    ctx = np.ascontiguousarray(np.asarray(context, np.int32).reshape(-1))
    L = int(ctx.size)
    if L < 2:
        return _EMPTY
    # windows over ctx[:-1]: the suffix itself is excluded, every
    # earlier (also overlapping) occurrence is a candidate
    for n in range(min(int(ngram_max), L - 1), 0, -1):
        hay = ctx[:L - 1]
        if hay.size < n:
            continue
        win = np.lib.stride_tricks.sliding_window_view(hay, n)
        hits = np.nonzero((win == ctx[L - n:]).all(axis=1))[0]
        if hits.size:
            return ctx[_continuation(int(hits[-1]), n, L, k)].astype(
                np.int32, copy=False)
    return _EMPTY


class PromptLookup:
    """Incremental prompt-lookup index of ONE stream: O(ngram_max) dict
    updates an emitted token, O(k) a proposal, the same proposals as
    :func:`propose_tokens`. For each n in 1..ngram_max it maps an
    n-gram to its two most recent start offsets: the most recent
    occurrence of the context's own suffix is the suffix itself, and
    the drafter wants the one before it."""

    def __init__(self, tokens, ngram_max: int = 3):
        self.n = max(1, int(ngram_max))
        self.toks: list = []
        # per n: {ngram tuple: (last_start, prev_start or None)}
        self._idx = [dict() for _ in range(self.n + 1)]
        self.extend(tokens)

    def extend(self, tokens):
        """Append emitted tokens, indexing every n-gram ending at each."""
        toks = self.toks
        for t in np.asarray(tokens, np.int32).reshape(-1):
            toks.append(int(t))
            end = len(toks)
            for n in range(1, min(self.n, end) + 1):
                key = tuple(toks[end - n:end])
                prev = self._idx[n].get(key)
                self._idx[n][key] = (end - n,
                                     prev[0] if prev is not None else None)

    def propose(self, k: int) -> np.ndarray:
        """Up to ``k`` tokens continuing the indexed context."""
        toks = self.toks
        L = len(toks)
        if k <= 0 or L < 2:
            return _EMPTY
        for n in range(min(self.n, L - 1), 0, -1):
            hit = self._idx[n].get(tuple(toks[L - n:]))
            if hit is None:
                continue
            last, prev = hit
            start = prev if last == L - n else last
            if start is None:
                continue
            return np.asarray([toks[i] for i in
                               _continuation(start, n, L, k)], np.int32)
        return _EMPTY


def accept_length(draft, verified) -> int:
    """Longest prefix of ``draft`` equal to the verify pass's canonical
    tokens: ``verified[j]`` is what the model emits after the context
    extended by ``draft[:j]``, drawn with the key plain decode would
    use, so ``verified[:accept_length + 1]`` is exactly the plain
    stream."""
    n = min(len(draft), len(verified))
    a = 0
    while a < n and int(draft[a]) == int(verified[a]):
        a += 1
    return a
