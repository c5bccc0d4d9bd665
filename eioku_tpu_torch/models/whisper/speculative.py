"""Speculative greedy decoding: a small draft model proposes, the target
verifies a block at a time (port of eioku_tpu/models/whisper/speculative.py).

Each round runs `gamma` greedy draft passes, then ONE target pass over the
drafted block, and keeps the drafted tokens up to the first mismatch or EOT
plus the target's own token after them (the "bonus" token), so the output is
the target's own greedy decode. Both models recompute the whole prefix with
`whisper_decode_full` (no KV cache), on cross-attention keys and values
computed once per call. The JAX package's `lax.while_loop` is a host loop
here that stops when every row has finished or filled `max_len`; each pass
runs on the prefix the round needs, which gives the same logits as the JAX
package's full-buffer pass under the causal mask.

`torch.argmax` and `jnp.argmax` both take the first maximum, and the
suppression masks are whisper_decode_windows' (greedy, timestamps off).
`score_sequences` recovers the silence gate's two signals for the decoded
rows, so the speculative path feeds the temperature fallback and the gate
as the standard decode does.
"""
from __future__ import annotations

import torch

from eioku_tpu_torch.models.whisper.model import (
    Whisper,
    precompute_cross_kv,
    whisper_decode_full,
)
from eioku_tpu_torch.models.whisper.tokenizer import WhisperTokens

_NEG = -1e9  # suppressed logit (the JAX module's value)


def _masked_argmax(logits: torch.Tensor, suppress_always: torch.Tensor,
                   suppress_begin: torch.Tensor, at_begin: torch.Tensor
                   ) -> torch.Tensor:
    """Greedy pick under suppress_always everywhere and suppress_begin at the
    first generated position (at_begin [B] bool)."""
    logits = logits.masked_fill(suppress_always[None], _NEG)
    logits = logits.masked_fill(at_begin[:, None] & suppress_begin[None], _NEG)
    return logits.argmax(dim=-1)


def _at(logits: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """logits[row, pos[row]] of logits [B, S, V]."""
    return logits[torch.arange(logits.shape[0], device=logits.device), pos]


@torch.no_grad()
def speculative_greedy_decode(t_model: Whisper, d_model: Whisper,
                              t_enc: torch.Tensor, d_enc: torch.Tensor,
                              initial_tokens: torch.Tensor,
                              suppress_always: torch.Tensor,
                              suppress_begin: torch.Tensor,
                              max_len: int = 224, gamma: int = 4
                              ) -> tuple[torch.Tensor, float]:
    """Decode B windows speculatively.

    t_enc / d_enc: each model's own encoder output for the same audio;
    initial_tokens [B, n_init] shared SOT prompts (the vocabularies must
    match). Returns (tokens [B, max_len] int64, EOT-padded; accept_rate, the
    share of drafted tokens the target kept)."""
    tk = WhisperTokens(t_model.cfg.vocab_size)
    eot = tk.eot
    dev = t_enc.device
    b, n_init = initial_tokens.shape
    sup_a, sup_b = suppress_always.to(dev), suppress_begin.to(dev)
    cols = torch.arange(max_len, device=dev)
    tokens = torch.full((b, max_len), eot, dtype=torch.long, device=dev)
    tokens[:, :n_init] = initial_tokens.to(dev, torch.long)
    length = torch.full((b,), n_init, dtype=torch.long, device=dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    t_kv = precompute_cross_kv(t_model, t_enc)
    d_kv = precompute_cross_kv(d_model, d_enc)
    acc_total = torch.zeros((), dtype=torch.long, device=dev)
    drafted_total = torch.zeros((), dtype=torch.long, device=dev)

    def pick(logits, pos):
        prev = (pos - 1).clamp(0, max_len - 1)
        return _masked_argmax(_at(logits, prev), sup_a, sup_b, prev == n_init - 1)

    while bool((~finished & (length < max_len)).any()):
        hi = int(length.max())
        # draft: gamma greedy steps of the small model
        drafted = tokens
        for g in range(gamma):
            pos = length + g
            d_logits = whisper_decode_full(
                d_model, drafted[:, :min(hi + g, max_len)], d_enc, d_kv)
            step = pick(d_logits, pos)
            write = (cols[None] == pos[:, None]) & ~finished[:, None] \
                & (pos < max_len)[:, None]
            drafted = torch.where(write, step[:, None], drafted)
        # verify: one target pass over the drafted block
        t_logits = whisper_decode_full(
            t_model, drafted[:, :min(hi + gamma, max_len)], t_enc, t_kv)
        new_tokens, new_len = tokens, length
        still = ~finished  # rows still accepting drafted tokens this round
        accepted = torch.zeros((b,), dtype=torch.long, device=dev)
        now_finished = finished
        for g in range(gamma + 1):  # the last slot is the bonus token
            pos = length + g
            t_tok = pick(t_logits, pos)
            d_tok = drafted.gather(1, pos.clamp(0, max_len - 1)[:, None])[:, 0]
            in_range = pos < max_len
            write = still & in_range
            new_tokens = torch.where((cols[None] == pos[:, None]) & write[:, None],
                                     t_tok[:, None], new_tokens)
            new_len = torch.where(write, pos + 1, new_len)
            now_finished = now_finished | (write & (t_tok == eot))
            if g < gamma:
                match = (t_tok == d_tok) & (t_tok != eot)
                accepted = accepted + (write & match).long()
                # stop at the first mismatch or EOT: the target's token
                # written at this step already corrects it
                still = still & match & in_range
            else:
                still = torch.zeros_like(still)
        acc_total = acc_total + accepted.sum()
        drafted_total = drafted_total + (~finished).long().sum() * gamma
        tokens, length = new_tokens, new_len
        finished = now_finished | (new_len >= max_len)
    # the tail: everything past the first generated EOT, or past the length,
    # is EOT padding, as whisper_decode_windows returns it
    is_eot = (tokens == eot) & (cols[None] >= n_init)
    first_eot = torch.where(is_eot.any(dim=1), is_eot.long().argmax(dim=1),
                            torch.full_like(length, max_len))
    tokens = torch.where(cols[None] > first_eot[:, None], eot, tokens)
    tokens = torch.where(cols[None] >= length[:, None], eot, tokens)
    return tokens, float(acc_total) / max(int(drafted_total), 1)


@torch.no_grad()
def score_sequences(t_model: Whisper, t_enc: torch.Tensor, tokens: torch.Tensor,
                    n_init: int, suppress_always: torch.Tensor,
                    suppress_begin: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced scores of decoded rows: (avg_logprob [B] over the
    generated tokens up to and including the first EOT, no_speech_prob [B]
    from the raw logits at position 0, the SOT token's), with
    suppress_begin applied only at the first generated position, as the
    incremental decoder masks it."""
    tk = WhisperTokens(t_model.cfg.vocab_size)
    dev = t_enc.device
    tokens = tokens.to(dev)
    b, max_len = tokens.shape
    raw = whisper_decode_full(t_model, tokens, t_enc)
    # no_speech is itself suppressed: read it before masking
    probs_sot = torch.softmax(raw[:, 0], dim=-1)
    logits = raw.masked_fill(suppress_always.to(dev)[None, None], _NEG)
    if suppress_begin is not None:
        at_begin = (torch.arange(max_len, device=dev) == n_init - 1)[None, :, None]
        logits = logits.masked_fill(at_begin & suppress_begin.to(dev)[None, None], _NEG)
    lp = torch.log_softmax(logits, dim=-1)
    # logits at column i predict token i + 1
    tok_lp = lp[:, :-1].gather(2, tokens[:, 1:, None])[..., 0]  # [B, max_len-1]
    cols = torch.arange(max_len - 1, device=dev)
    gen = cols[None] >= n_init - 1
    is_eot = (tokens[:, 1:] == tk.eot) & gen
    first_eot = torch.where(is_eot.any(dim=1), is_eot.long().argmax(dim=1),
                            torch.full((b,), max_len - 2, device=dev))
    counted = gen & (cols[None] <= first_eot[:, None])  # the EOT included
    avg_lp = torch.where(counted, tok_lp, 0.0).sum(dim=1) / \
        counted.sum(dim=1).clamp_min(1)
    return avg_lp, probs_sot[:, tk.no_speech]
