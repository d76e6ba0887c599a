"""Self-speculative decoding over the uniform chunk step (DESIGN.md §15).

Kraken's serving engine already runs every request phase through one
fixed-shape mixed program (``Model.chunk_step``: a decoding slot is a
length-1 prefill chunk, an idle slot a length-0 identity row).  Verifying
k draft tokens is *the same program* with the chunk carrying drafts
instead of prompt tokens — multi-mode decode through one engine, the
serving restatement of the paper's one-uniform-dataflow thesis — so
speculative decoding adds **zero compiled programs**: the verify step is
the mixed step, and accept/rollback is eager host bookkeeping plus
``StateTree.truncate``.

This module owns the model-free half of the subsystem:

* :class:`Drafter` — the proposal protocol.  ``propose(history, k)``
  returns up to ``k`` candidate continuation tokens given the request's
  *committed* token history (prompt + accepted output).  Drafters never
  see unaccepted speculation, so a drafter can never launder a rejected
  token back into its own evidence.
* :class:`NGramDrafter` — prompt-lookup self-speculation (no second
  model): find the most recent earlier occurrence of the history's
  trailing n-gram and propose the tokens that followed it.  Greedy
  decode loves to repeat itself — system prompts, code, boilerplate,
  and degenerate loops all contain their own future — which is exactly
  when extra decode steps are pure waste.
* :func:`greedy_accept` — the accept walk over the verify chunk's argmax
  chain: accept the longest draft prefix matching the chain, then take
  the first correction token (the model's own continuation), so every
  verify step emits at least one token and the emitted stream is
  **token-identical** to plain greedy decode by construction.

Engine-side packing, per-slot draft budgeting, and the truncate-based
rollback live in :mod:`repro_torch.serving.engine`; the state-side rewind
(``PagedKVState``/``SlotRowState``/``StateTree.truncate``) in
:mod:`repro_torch.serving.state`.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class Drafter(Protocol):
    """The draft-proposal protocol.

    ``history`` is the request's committed token stream (prompt followed
    by every accepted output token), ``k`` the maximum number of drafts
    the engine has budget for this step.  Implementations return an int32
    array of **up to** ``k`` proposals (possibly empty — proposing
    nothing falls back to plain decode for the step) and must be pure
    host-side: a drafter never touches device state.
    """

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        ...


class NGramDrafter:
    """Prompt-lookup self-speculation: propose the continuation of the
    most recent earlier occurrence of the history's trailing n-gram.

    Matching tries the longest n-gram first (``max_n`` down to ``min_n``)
    and, within one n, the *most recent* earlier occurrence — recency is
    the better predictor under greedy decode, where the tail of the
    stream is the context the model is actually conditioned on.  No
    second model, no device work: O(|history| · n) numpy per call.
    """

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not (1 <= min_n <= max_n):
            raise ValueError("need 1 <= min_n <= max_n")
        self.max_n = int(max_n)
        self.min_n = int(min_n)

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        h = np.asarray(history, np.int32).reshape(-1)
        empty = np.zeros((0,), np.int32)
        if k <= 0 or len(h) < self.min_n + 1:
            return empty
        for n in range(min(self.max_n, len(h) - 1), self.min_n - 1, -1):
            tail = h[len(h) - n:]
            # windows over h[:-1]: every start s <= len(h)-1-n, so the
            # trailing n-gram itself is never its own match and the
            # continuation h[s+n] always exists
            if len(h) - 1 < n:
                continue
            win = np.lib.stride_tricks.sliding_window_view(h[:-1], n)
            hits = np.flatnonzero((win == tail).all(axis=1))
            if hits.size:
                s = int(hits[-1])               # most recent occurrence
                return h[s + n:s + n + k].astype(np.int32)
        return empty


def greedy_accept(drafts, greedy_row, j0: int) -> tuple[int, list[int]]:
    """The accept walk for one verified slot.

    ``greedy_row`` is the verify chunk's per-column argmax chain for the
    slot (``greedy_row[j]`` = the model's next token after consuming the
    row's tokens ``0..j``); ``j0`` the column of the first *new*
    continuation (``n_pending - 1`` — the committed re-fed prefix ends
    there).  Drafts were fed at columns ``j0+1..``, so draft ``a`` is
    correct iff it equals ``greedy_row[j0 + a]`` — the token the model
    would have emitted anyway.

    Returns ``(a, tokens)``: ``a`` accepted drafts and the ``a + 1``
    tokens to emit — the accepted drafts plus the first correction
    (``greedy_row[j0 + a]``, the model's own continuation past the
    divergence), exactly the stream plain greedy decode would produce.
    """
    drafts = np.asarray(drafts, np.int32).reshape(-1)
    k = len(drafts)
    a = 0
    while a < k and int(drafts[a]) == int(greedy_row[j0 + a]):
        a += 1
    return a, [int(greedy_row[j0 + j]) for j in range(a + 1)]
