"""Whisper decoding with OpenAI-rule logit filters and beam search (port of
eioku_tpu/models/whisper/decoding.py).

The standard Whisper decode constraints: special and non-speech token
suppression, blank and EOT suppression at the first generated position,
the timestamp rules, a no-speech probability read after SOT, and beam search
(faster-whisper's default beam_size 5). Beams are folded into the batch
([B windows, K beams] -> B*K rows); finished beams are frozen in place (their
only candidate is EOT at logprob 0). The JAX package's `lax.while_loop` is a
Python loop here that stops when every row has finished or the length cap
is reached; each step is one `decoder_step` plus a few tensor operations on
the device.

Timestamp rules (the public Whisper reference decoder's):
  - the no-timestamps token is suppressed when timestamps are requested;
  - timestamps come in pairs: after a segment-end timestamp the next token
    must be text; after a segment-start timestamp, text or a closing
    timestamp; the first generated token must be a timestamp;
  - timestamps are monotonically non-decreasing within a window;
  - the first timestamp is capped at `max_initial_ts_index` (1.0 s default);
  - if the total probability mass on timestamp tokens exceeds the most likely
    text token, a timestamp is forced.
"""
from __future__ import annotations

import numpy as np
import torch

from eioku_tpu_torch.models.whisper.model import (
    Whisper,
    WhisperShards,
    decoder_step,
    decoder_step_tp,
    precompute_cross_kv,
    precompute_cross_kv_tp,
    shard_whisper,
)
from eioku_tpu_torch.models.whisper.tokenizer import WhisperTokens
from eioku_tpu_torch.parallel.mesh import Mesh
from eioku_tpu_torch.utils.metrics import METRICS

# Token ids of sounds/symbols that never occur in speech in the multilingual
# Whisper vocabulary: the published `suppress_tokens` list (ids below the
# special-token range; specials are masked from the vocab layout).
NON_SPEECH_TOKENS = (
    1, 2, 7, 8, 9, 10, 14, 25, 26, 27, 28, 29, 31, 58, 59, 60, 61, 62, 63,
    90, 91, 92, 93, 359, 503, 522, 542, 873, 893, 902, 918, 922, 931, 1350,
    1853, 1982, 2460, 2627, 3246, 3253, 3268, 3536, 3846, 3961, 4183, 4667,
    6585, 6647, 7273, 9061, 9383, 10428, 10929, 11938, 12033, 12331, 12562,
    13793, 14157, 14635, 15265, 15618, 16553, 16604, 18362, 18956, 20075,
    21675, 22520, 26130, 26161, 26435, 28279, 29464, 31650, 32302, 32470,
    36865, 42863, 47425, 49870, 50254,
)

BLANK_TOKEN = 220  # byte-BPE id of " "

NEG = -1e30  # suppressed logit (the JAX package's float32 value)


def build_suppress_masks(tokens: WhisperTokens, timestamps: bool,
                         non_speech: bool = True
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(suppress_always [vocab] bool, suppress_begin [vocab] bool) on the
    CPU: `suppress_always` applies at every generation step,
    `suppress_begin` additionally at the first generated position (blank +
    EOT, so a window never opens with silence or an immediate stop)."""
    vocab = tokens.vocab_size
    always = np.zeros(vocab, bool)
    # sot, languages, translate/transcribe, sot_lm, sot_prev, no_speech
    always[tokens.sot:tokens.no_speech + 1] = True
    always[tokens.no_timestamps] = True
    if not timestamps:
        always[tokens.timestamp_begin:] = True
    if non_speech:
        always[list(NON_SPEECH_TOKENS)] = True
    begin = np.zeros(vocab, bool)
    begin[BLANK_TOKEN] = True
    begin[tokens.eot] = True
    return torch.from_numpy(always), torch.from_numpy(begin)


def _apply_timestamp_rules(logits: torch.Tensor, tokens: torch.Tensor, pos: int,
                           n_init: int, ts_begin: int, eot: int,
                           max_initial_ts_index: int) -> torch.Tensor:
    dev = logits.device
    max_len = tokens.shape[1]
    vocab_ids = torch.arange(logits.shape[1], device=dev)
    gen_cols = torch.arange(max_len, device=dev)
    gen_mask = (gen_cols >= n_init) & (gen_cols <= pos)  # sampled region
    is_ts = (tokens >= ts_begin) & gen_mask[None]
    # the rules keep timestamps non-decreasing, so the max is the latest
    last_ts = torch.where(is_ts, tokens, -1).amax(dim=-1)  # [BK]
    last_tok = tokens[:, pos]
    penult_tok = tokens[:, max(pos - 1, 0)]
    last_was_ts = (last_tok >= ts_begin) & (pos >= n_init)
    penult_was_ts = (penult_tok >= ts_begin) | (pos - 1 < n_init)
    is_ts_col = (vocab_ids >= ts_begin)[None]
    is_text_col = (vocab_ids < eot)[None]
    # segment-end timestamp (a closed pair): next token must be text
    logits = logits.masked_fill((last_was_ts & penult_was_ts)[:, None] & is_ts_col,
                                NEG)
    # segment-start timestamp: next must close the pair (or EOT)
    logits = logits.masked_fill((last_was_ts & ~penult_was_ts)[:, None]
                                & is_text_col, NEG)
    # monotonic: suppress [ts_begin, floor); an open pair may repeat the
    # same timestamp, a closed pair must advance past it
    floor = torch.where(last_was_ts & ~penult_was_ts, last_ts, last_ts + 1)
    logits = logits.masked_fill((last_ts >= 0)[:, None] & is_ts_col
                                & (vocab_ids[None] < floor[:, None]), NEG)
    if pos == n_init - 1:  # the first generated token is an early timestamp
        logits = logits.masked_fill(
            ((vocab_ids < ts_begin)
             | (vocab_ids > ts_begin + max_initial_ts_index))[None], NEG)
    # probability-mass rule: timestamps together more likely than any single
    # text token -> force a timestamp
    lp = torch.log_softmax(logits, dim=-1)
    ts_mass = torch.logsumexp(lp[:, ts_begin:], dim=-1)
    max_text = lp[:, :ts_begin].amax(dim=-1)
    return logits.masked_fill((ts_mass > max_text)[:, None]
                              & (vocab_ids < ts_begin)[None], NEG)


def _top_k_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim, ties to the lower index (jax.lax.top_k's
    order): a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _each(fn, x):
    """fn(x), or fn of each entry of a per-shard list."""
    return [fn(t) for t in x] if isinstance(x, list) else fn(x)


@torch.no_grad()
def whisper_decode_windows(model: Whisper, enc_out: torch.Tensor,
                           initial_tokens: torch.Tensor,
                           suppress_always: torch.Tensor,
                           suppress_begin: torch.Tensor,
                           max_len: int = 224, beam_size: int = 1,
                           timestamps: bool = True,
                           max_initial_ts_index: int = 50,
                           sot_index: int = 0, sample: bool = False,
                           temperature: float = 1.0,
                           generator: torch.Generator | None = None,
                           step_fn=None, cross_kv_fn=None,
                           kv_dim: int | None = None):
    """Decode a batch of encoded 30 s windows with beam search + logit rules.

    enc_out [B, 1500, d]; initial_tokens [B, n_init] SOT sequences.
    sot_index: position of the SOT token in the prompt (0 for plain prompts,
    1 + len(prev) after a sot_prev context): the no-speech probability is
    read from the distribution after consuming SOT.
    sample=True switches from beam search to `beam_size` independent
    sampling chains at `temperature` (faster-whisper's `best_of`), drawn
    from `generator` (on enc_out's device), which must be given; ranking
    still picks the chain with the best average unscaled logprob.
    step_fn / cross_kv_fn / kv_dim: the tensor-parallel decode
    (`whisper_decode_windows_tp`) swaps in `decoder_step_tp` with per-shard
    lists of cross K/V and of caches of kv_dim features (each cache on its
    shard's device); the defaults are the one-device `decoder_step`,
    `precompute_cross_kv` and the model's width.
    Returns (tokens [B, max_len] int64, the best beam per window, prompt
    included and EOT-padded; avg_logprob [B] float32 over generated tokens
    incl. EOT; no_speech_prob [B] float32)."""
    cfg = model.cfg
    tk = WhisperTokens(cfg.vocab_size)
    eot, ts_begin, vocab = tk.eot, tk.timestamp_begin, cfg.vocab_size
    dev = enc_out.device
    b, k = enc_out.shape[0], beam_size
    bk = b * k
    n_init = initial_tokens.shape[1]
    if sample and generator is None:
        raise ValueError("sample=True needs a generator")
    suppress_always = suppress_always.to(dev)
    suppress_begin = suppress_begin.to(dev)

    step_fn = step_fn or decoder_step
    with METRICS.span("decode.cross_kv"):
        # [L, B, S, d]: beams fold into the token batch, cross-KV stays one
        # row per window (decoder_step groups each window's k beams onto it)
        cross_k, cross_v = (cross_kv_fn or precompute_cross_kv)(model, enc_out)
        tokens = torch.full((bk, max_len), eot, dtype=torch.long, device=dev)
        tokens[:, :n_init] = initial_tokens.to(dev, torch.long).repeat_interleave(k, 0)

        def new_cache(ck: torch.Tensor) -> torch.Tensor:  # beside its cross K
            return torch.zeros((cfg.n_dec_layers, bk, max_len, kv_dim or cfg.dim),
                               dtype=enc_out.dtype, device=ck.device)
        self_k, self_v = _each(new_cache, cross_k), _each(new_cache, cross_k)
    no_speech = torch.zeros((bk,), dtype=torch.float32, device=dev)
    with METRICS.span("decode.prefill"):
        for pos in range(n_init - 1):  # prefill: all but the last prompt token
            logits = step_fn(model, cross_k, cross_v, tokens, self_k, self_v, pos)
            if pos == sot_index:
                no_speech = torch.softmax(logits.float(), dim=-1)[:, tk.no_speech]

    if sample:  # sampling chains are independent from the start: all live
        sum_lp = torch.zeros((b, k), dtype=torch.float32, device=dev)
    else:  # identical initial beams: only beam 0 may seed candidates
        sum_lp = torch.where(torch.arange(k, device=dev) == 0, 0.0, -1e9
                             ).float()[None].repeat(b, 1)
    n_gen = torch.zeros((b, k), dtype=torch.long, device=dev)
    finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
    eot_only = torch.full((vocab,), NEG, dtype=torch.float32, device=dev)
    eot_only[eot] = 0.0
    rows = torch.arange(b, device=dev)

    pos = n_init - 1
    while pos < max_len - 1:
        with METRICS.span("decode.sync"):  # the step's one wait for the device
            done = bool(finished.all())
        if done:
            break
        with METRICS.span("decode.forward"):
            logits = step_fn(model, cross_k, cross_v, tokens, self_k, self_v, pos)
        with METRICS.span("decode.select"):
            logits = logits.float().masked_fill(suppress_always[None], NEG)
            if pos == n_init - 1:
                logits = logits.masked_fill(suppress_begin[None], NEG)
            if timestamps:
                logits = _apply_timestamp_rules(logits, tokens, pos, n_init, ts_begin,
                                                eot, max_initial_ts_index)
            logprobs = torch.log_softmax(logits, dim=-1)  # [BK, V]
            # frozen (finished) beams contribute one candidate: EOT at 0
            logprobs = torch.where(finished.reshape(bk)[:, None], eot_only[None],
                                   logprobs)
            if sample:
                # independent chains, Gumbel-max draws from softmax(lp / T); no
                # candidate pooling, no KV reordering
                u = torch.rand(logprobs.shape, generator=generator, device=dev)
                gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
                sampled = (logprobs / max(temperature, 1e-3) + gumbel).argmax(dim=-1)
                chosen_lp = logprobs.gather(1, sampled[:, None])[:, 0]
                new_tok = sampled.reshape(b, k)
                was_finished = finished
                sum_lp = sum_lp + torch.where(was_finished, 0.0, chosen_lp.reshape(b, k))
            else:
                cand = (sum_lp.reshape(bk, 1) + logprobs).reshape(b, k * vocab)
                top_lp, top_idx = _top_k_stable(cand, k)  # [B, K]
                src_beam = top_idx // vocab
                new_tok = top_idx % vocab
                if k > 1:  # greedy (k = 1) needs no beam reordering
                    flat_src = (rows[:, None] * k + src_beam).reshape(bk)
                    tokens = tokens.index_select(0, flat_src)
                    self_k, self_v = (_each(lambda c: c.index_select(1, flat_src.to(c.device)),
                                            cache) for cache in (self_k, self_v))
                    no_speech = no_speech.index_select(0, flat_src)
                    n_gen = n_gen.gather(1, src_beam)
                    was_finished = finished.gather(1, src_beam)
                else:
                    was_finished = finished
                sum_lp = top_lp
            n_gen = n_gen + (~was_finished).long()
            finished = was_finished | (new_tok == eot)
            tokens[:, pos + 1] = new_tok.reshape(bk)
        pos += 1
    METRICS.count("decode_steps", pos)  # prefill's n_init - 1 and the loop's

    avg_lp = sum_lp / n_gen.float().clamp(min=1.0)
    # beams that closed with EOT outrank ones cut off at max_len
    rank = torch.where(finished, avg_lp, avg_lp - 1e4)
    best = rank.argmax(dim=1)  # [B], first maximum on ties
    best_tokens = tokens.reshape(b, k, max_len)[rows, best]
    return best_tokens, avg_lp[rows, best], no_speech.reshape(b, k)[:, 0]


@torch.no_grad()
def whisper_decode_windows_tp(model: Whisper | WhisperShards, enc_out: torch.Tensor,
                              initial_tokens: torch.Tensor,
                              suppress_always: torch.Tensor,
                              suppress_begin: torch.Tensor,
                              mesh: Mesh | None = None, axis: str = "model",
                              **kwargs):
    """Tensor-parallel `whisper_decode_windows`: the KV-cached beam loop with
    Megatron-sharded decoder weights (`decoder_step_tp`: caches of d/tp
    features per shard, one psum per residual branch and one for the tied
    logits). Beam, top-k and sampling logic run once on the summed logits,
    which every shard has alike. model: a Whisper (sharded over `mesh` for
    this call) or its `WhisperShards`, reused across calls (the temperature
    ladder's five decodes share one set). Takes whisper_decode_windows'
    keyword arguments; n_heads must divide by the axis size."""
    shards = shard_whisper(model, mesh, axis)
    return whisper_decode_windows(
        shards.lines[0], enc_out, initial_tokens, suppress_always, suppress_begin,
        step_fn=decoder_step_tp, cross_kv_fn=precompute_cross_kv_tp,
        kv_dim=shards.cfg.dim // shards.tp, **kwargs)
