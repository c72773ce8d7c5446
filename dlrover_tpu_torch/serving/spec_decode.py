"""Self-speculative decoding: drafters + the batched accept/reject law
(port of ``dlrover_tpu/serving/spec_decode.py``).

A decode step buys one token per sweep over the weights and the cache.
Speculative decoding drafts up to K cheap continuation tokens per slot,
then verifies all of them in ONE batched forward over [slots, K + 1]
tokens; every accepted draft is a token that rode on the verification
sweep. Both drafters come from the serving model itself:

- **n-gram / prompt lookup** (:func:`propose_ngram`): host numpy suffix
  matching over the request's own prompt + generated tokens. No device
  work; strong where text repeats.
- **early exit**: K single-token forwards through the FIRST
  ``draft_layers`` decoder blocks of the same weights, greedy through
  the shared head. The engines build it (``serving/engine.py``,
  ``serving/kvpool/engine.py``) because their cache plumbing differs;
  its drafted partial-layer rows land beyond the fill, where nothing
  reads them before the verify pass rewrites them.

Verification (:func:`spec_accept`) runs on the device: greedy rows
accept a draft iff it IS the argmax (token-exact against one-token
decode by construction), sampled rows use rejection sampling against
the deterministic drafter, and the first rejection ends the chain.
Rollback is free: rejected rows sit beyond the advanced fill, and rows
at or past the fill are never read.

The sampled rows draw their uniforms and their gumbel noise from an
explicit ``torch.Generator``; they follow the same law as the
reference's ``fold_in`` keys, not the same bits.
"""

from typing import Optional

import numpy as np
import torch

from dlrover_tpu_torch.models import generate as gen_lib
from dlrover_tpu_torch.ops.attention import NEG_INF

SPEC_DRAFTERS = ("ngram", "early_exit")


def propose_ngram(
    history: np.ndarray, k: int, max_ngram: int = 3
) -> np.ndarray:
    """Prompt-lookup draft: match the sequence's own recent suffix.

    Finds the RIGHTMOST earlier occurrence of the longest suffix
    n-gram (``max_ngram`` down to 1) of ``history`` and proposes the
    up-to-``k`` tokens that followed it. Host-only numpy; returns an
    empty array when nothing matches (the engine then runs that slot as
    a one-token decode, draft_len 0)."""
    history = np.asarray(history, np.int32).reshape(-1)
    n = int(history.shape[0])
    if k <= 0 or n < 2:
        return np.zeros(0, np.int32)
    for g in range(min(max_ngram, n - 1), 0, -1):
        pat = history[n - g:]
        # Candidate starts 0..n-g-1: a window ending before the suffix
        # itself, so a continuation token exists.
        mask = history[: n - g] == pat[0]
        for j in range(1, g):
            mask &= history[j : j + n - g] == pat[j]
        hits = np.nonzero(mask)[0]
        if hits.size:
            s = int(hits[-1])
            cont = history[s + g : s + g + k]
            if cont.size:
                return cont.astype(np.int32)
    return np.zeros(0, np.int32)


def spec_accept(
    logits: torch.Tensor,      # [slots, T, V] f32 — verify logits, T = K+1
    drafts: torch.Tensor,      # [slots, K] int — drafted tokens
    draft_len: torch.Tensor,   # [slots] int — valid drafts per slot (0..K)
    temps,                     # [slots] f32 host array or tensor; <= 0 greedy
    active: torch.Tensor,      # [slots] bool
    fed_tokens: torch.Tensor,  # [slots] int — the fed token
    generator: Optional[torch.Generator] = None,
):
    """The batched accept/reject law.

    Greedy rows (t <= 0): draft i+1 is accepted iff it equals
    ``argmax(logits[i])``, so the emitted chain is what sequential
    greedy decode would give for the same logits.

    Sampled rows: the drafters are deterministic (a point mass on the
    drafted token), so rejection sampling reduces to: accept draft d_i
    with probability p_i(d_i); on the first rejection sample the
    correction from the residual (p_i with d_i masked out,
    renormalised); when every valid draft survives, sample the bonus
    token from the model's own next distribution. Both final picks go
    through :func:`gen_lib.sample_token_logprobs` in one call: a greedy
    row's mask can only remove a non-argmax token, so the masked pick
    is its plain argmax.

    Host temperatures that are all <= 0 draw no random numbers.

    Returns ``(emitted [slots, T] int32, accept_len [slots] int32)``:
    ``emitted[s, :accept_len[s]]`` are the accepted drafts and
    ``emitted[s, accept_len[s]]`` the correction or bonus token.
    Inactive rows emit their fed token and accept nothing."""
    slots, T, V = logits.shape
    K = T - 1
    dev = logits.device
    drafts = drafts.long()
    draft_len = draft_len.long()
    greedy = not isinstance(temps, torch.Tensor) and bool(
        (np.asarray(temps, np.float32) <= 0.0).all())
    if K:
        m = logits.argmax(dim=-1)                        # [slots, T]
        ok = drafts == m[:, :K]
        if not greedy:
            tcol = torch.as_tensor(temps, dtype=torch.float32,
                                   device=dev)[:, None]   # [slots, 1]
            scaled = logits[:, :K] / torch.clamp(tcol, min=1e-6)[..., None]
            logp = torch.log_softmax(scaled.float(), dim=-1)
            p_draft = logp.gather(-1, drafts[..., None])[..., 0]
            u = torch.rand((slots, K), generator=generator, device=dev)
            u = torch.clamp(u, min=1e-20)
            ok = torch.where(tcol > 0.0, torch.log(u) < p_draft, ok)
        valid = torch.arange(K, device=dev)[None, :] < draft_len[:, None]
        acc = torch.cumprod((ok & valid).long(), dim=1)
        a = acc.sum(dim=1)                               # [slots] 0..K
    else:
        a = torch.zeros(slots, dtype=torch.long, device=dev)
    # The final pick at position a: a < draft_len -> the rejection
    # CORRECTION (the rejected draft masked out); a == draft_len -> the
    # BONUS token from the model's own distribution.
    logits_a = logits.gather(1, a[:, None, None].expand(slots, 1, V))[:, 0]
    if K:
        rejected = a < draft_len
        d_a = drafts.gather(1, torch.clamp(a, max=K - 1)[:, None])[:, 0]
        mask = rejected[:, None] & (
            torch.arange(V, device=dev)[None, :] == d_a[:, None]
        )
        logits_a = torch.where(mask, NEG_INF, logits_a)
    t_fin, _ = gen_lib.sample_token_logprobs(logits_a, temps, generator)
    t_fin = torch.where(active, t_fin.long(), fed_tokens.long())
    a = torch.where(active, a, 0)
    pos = torch.arange(T, device=dev)[None, :]
    drafts_pad = torch.cat(
        [drafts, torch.zeros((slots, 1), dtype=torch.long, device=dev)],
        dim=1,
    )
    emitted = torch.where(pos < a[:, None], drafts_pad, t_fin[:, None])
    return emitted.to(torch.int32), a.to(torch.int32)


def clamp_draft_len(
    k: int, tokens_done: int, max_new_tokens: int,
    fill: int, max_len: int,
) -> int:
    """Per-slot draft budget: never draft past the request's remaining
    token budget (the verify step always emits one final token on top
    of the accepted drafts) or past the cache rows that can become
    visible (``fill + accepted + 1 <= max_len``). The one clamp shared
    by both engines and both drafters."""
    room_tokens = max_new_tokens - tokens_done - 1
    room_rows = max_len - 1 - fill
    return max(0, min(k, room_tokens, room_rows))
