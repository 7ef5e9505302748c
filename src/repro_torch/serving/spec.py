"""Model-free self-speculative decoding: prompt-lookup drafting.

ArcLight's decode loop is memory-bound — each step streams the whole
model once to emit ONE token.  Speculative decoding amortises that
stream: a cheap **drafter** guesses the next ``k`` tokens, one batched
**verify** forward scores all ``k + 1`` positions against the paged KV
cache, and the engine accepts the longest prefix of the draft that
matches the model's own greedy choices.  Every accepted draft token is
a decode forward the hardware never ran.

This module is the drafter half, and it is deliberately *model-free*
("Inference Acceleration for Large Language Models on CPUs",
PAPERS.md): no second network, no extra weights resident — the draft
is a **prompt lookup**.  LLM output constantly re-quotes its own
context (code identifiers, retrieved passages, chat boilerplate), so
the best guess for what follows the current suffix n-gram is whatever
followed its last occurrence earlier in prompt + generated history.

Byte parity is the engine's contract, not ours: the verify step emits
only tokens the model itself would have produced greedily (accepted
drafts all equal the model's argmax; the first mismatch is *replaced*
by the model's argmax — the "bonus" token).  A useless drafter costs
throughput, never correctness.

Kept dependency-free (no device code) so the host-side scheduler can import
:func:`lookahead_for` without touching device code.
"""

from __future__ import annotations

from typing import List, Sequence

#: default n-gram window bounds for :func:`propose` — try the longest
#: suffix first (most specific context), fall back to shorter ones
MIN_NGRAM = 1
MAX_NGRAM = 3

#: per-sequence speculation auto-off (ROADMAP: "use the live
#: spec.accept_rate signal"): once a sequence has AUTO_OFF_WINDOW
#: verify steps of history and its windowed acceptance rate sits below
#: AUTO_OFF_THRESHOLD, drafting for that sequence is pure overhead —
#: every rejected draft row is a KV page grant + a verify lane the
#: hardware ran for nothing — so the engine flips it off for the rest
#: of the sequence's life (preemption-restart included: the text that
#: defeated the drafter is still the text).
AUTO_OFF_WINDOW = 4
AUTO_OFF_THRESHOLD = 0.25


def propose(context: Sequence[int], k: int, *,
            min_ngram: int = MIN_NGRAM,
            max_ngram: int = MAX_NGRAM) -> List[int]:
    """Draft up to ``k`` tokens by prompt lookup over ``context``.

    Scans for the **longest** suffix n-gram (``max_ngram`` down to
    ``min_ngram`` tokens) that also occurs earlier in ``context``,
    preferring the **most recent** earlier occurrence, and returns the
    tokens that followed it.  Returns ``[]`` when nothing in the
    history continues the current suffix — the engine then falls back
    to a plain one-token decode for this sequence.

    O(len(context) * max_ngram) worst case per call; contexts here are
    a single request's prompt + generation, so this stays host-cheap
    next to a model forward.
    """
    n = len(context)
    if k <= 0 or n < min_ngram + 1:
        return []
    ctx = list(context)
    hi = min(max_ngram, n - 1)
    for size in range(hi, min_ngram - 1, -1):
        pattern = ctx[n - size:]
        for start in range(n - size - 1, -1, -1):
            if ctx[start:start + size] == pattern:
                # start <= n - size - 1, so at least one continuation
                # token always exists
                return ctx[start + size:start + size + k]
    return []


def lookahead_for(seq, k: int, max_len: int) -> int:
    """Worst-case draft lookahead the engine may use for ``seq`` this
    step — the page-grant bound the scheduler grows block tables by,
    and the cap the engine clamps :func:`propose` results to.

    Zero (no speculation) when:

    * ``k`` is zero — speculation disabled;
    * the sequence tripped the acceptance auto-off
      (``seq.spec_disabled``, see :func:`note_accept`);
    * the lane samples (``temperature > 0``) — acceptance compares
      drafts against the greedy argmax, which is only the lane's real
      output when the lane itself is greedy.  Byte parity over lenient
      acceptance, per the ISSUE contract;
    * the sequence is still prefilling.

    Otherwise ``k`` clamped so that (a) every speculative KV row lands
    strictly inside ``max_len`` (highest written position is
    ``next_pos - 1 + k``) and (b) a fully-accepted step (``k + 1``
    emitted tokens) cannot overshoot the request's ``max_new_tokens``.
    """
    if k <= 0 or seq.is_prefilling:
        return 0
    if getattr(seq, "spec_disabled", False):
        return 0
    sp = seq.request.sampling
    if sp.temperature > 0.0:
        return 0
    room_len = max_len - seq.next_pos - 1
    room_new = sp.max_new_tokens - len(seq.generated) - 1
    return max(0, min(k, room_len, room_new))


def note_accept(seq, accepted: int, drafted: int, *,
                window: int = AUTO_OFF_WINDOW,
                threshold: float = AUTO_OFF_THRESHOLD) -> bool:
    """Record one verify step's (accepted, drafted) outcome on ``seq``
    and apply the auto-off policy over the last ``window`` steps.

    Returns True exactly once — on the step that trips the breaker
    (``seq.spec_disabled`` goes False -> True) — so the caller can count
    ``spec.auto_disabled`` without double-counting.  Steps that drafted
    nothing (empty :func:`propose` result) carry no acceptance signal
    and are ignored.
    """
    if drafted <= 0 or seq.spec_disabled:
        return False
    seq.spec_recent.append((accepted, drafted))
    if len(seq.spec_recent) > window:
        del seq.spec_recent[0]
    if len(seq.spec_recent) < window:
        return False
    a = sum(x for x, _ in seq.spec_recent)
    m = sum(x for _, x in seq.spec_recent)
    if a < threshold * m:
        seq.spec_disabled = True
        return True
    return False
