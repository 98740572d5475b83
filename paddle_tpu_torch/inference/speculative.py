"""Speculative decoding: prompt-lookup n-gram drafting (counterpart of
``paddle_tpu/inference/speculative.py``, the port's own copy).

Most serving traffic -- summarization, extraction, code edits, RAG over
retrieved text -- repeats long spans of its own context, so the best guess
of the next K tokens is often what followed the last earlier occurrence of
the current suffix.  Drafting is host-side numpy: it needs the token
history the device never stores as a sequence and costs microseconds next
to a device forward.  Verification is one device step of the serving
engine (``ContinuousBatchingEngine._spec_step`` over the paged verify
walk), whose acceptance rule emits exactly the tokens the
non-speculative engine would have: a wrong draft costs one wasted verify
row, never a wrong token.
"""

from __future__ import annotations

import numpy as np

__all__ = ["NGramDrafter"]


class NGramDrafter:
    """Prompt-lookup drafter: longest-suffix n-gram match over the request's
    own prompt + generated history.

    For n from ``max_ngram`` down to ``min_ngram``: take the context's last
    n tokens and look for the MOST RECENT earlier occurrence; on a hit,
    propose the up-to-``num_draft_tokens`` tokens that followed it.  No
    match at any n -> empty proposal (the engine then runs its normal
    decode step).  Stateless across calls, so preemption needs no drafter
    bookkeeping.
    """

    def __init__(self, num_draft_tokens: int = 4, max_ngram: int = 3,
                 min_ngram: int = 1):
        if num_draft_tokens < 1:
            raise ValueError(f"num_draft_tokens must be >= 1, got "
                             f"{num_draft_tokens}")
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(f"need 1 <= min_ngram <= max_ngram, got "
                             f"{min_ngram}, {max_ngram}")
        self.num_draft_tokens = int(num_draft_tokens)
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose(self, context) -> np.ndarray:
        """Draft tokens continuing ``context`` (1-D int token ids): an int32
        array of 0..num_draft_tokens proposals."""
        ids = np.asarray(context, np.int32).ravel()
        L = ids.size
        # windows over ids[:-1]: a match starting at i has its continuation
        # at i+n <= L-1, and the context's own trailing n-gram (start L-n)
        # can never match itself
        for n in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            pat = ids[L - n:]
            win = np.lib.stride_tricks.sliding_window_view(ids[:-1], n)
            hits = np.nonzero((win == pat).all(axis=1))[0]
            if hits.size:
                start = int(hits[-1]) + n      # most recent occurrence wins
                return ids[start:start + self.num_draft_tokens].copy()
        return np.zeros(0, np.int32)
