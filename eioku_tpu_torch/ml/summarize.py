"""Chapters of a transcript: the `summarization` task, a language model of
`models/llm/` writing a recording's chapters from its transcript. No
counterpart in the JAX package. The model's `model_type` chooses the path:
Moonlight-16B-A3B (`deepseek_v3`, the default) writes a title and summary
for each section; Kimi-Linear-48B-A3B (`kimi_linear`) writes the chapter
list of the whole transcript at once.

The transcript's rows, as `transcription` returns them, come in through
`config["segments"]`. They are cut at segment boundaries into near-equal
sections of at most `section_tokens` transcript tokens (2,048), each line
`[mm:ss] text`. Each prompt is BOS, a fixed instruction, the section's
lines and a cue. A job's sections run in batches of at most DECODE_ROWS
(8) rows: one prefill of the right-padded prompts, then greedy decode
steps for every row at once through the latent cache, `max_new_tokens`
(192) ids a row. On the card a batch is padded to DECODE_ROWS rows and
each decode step replays the CUDA graph of its shape (`models/llm/model.py`
`decode_graph`, held by `models/step_graphs.py`), so that one shape serves
every batch. With `stop_at_eos` (the default) the rows stop once each has
emitted EOS, checked every `EOS_CHECK_STEPS` steps (the one read of the
device inside the loop) and cut there; without it every row runs all
steps.

Kimi-Linear takes the whole transcript as one prompt (BOS, WHOLE_INSTRUCTION,
every `[h:mm:ss] text` line, WHOLE_CUE) and decodes it as one row, with no
padding rows; on the card the cache's length is `cache_tokens` where that
is longer than the prompt and the new tokens rounded up to LENGTH_BUCKET,
so that jobs of every length up to it replay one decode graph. It returns
one row for the whole recording.

Other settings: `model` ("moonlight-16b-a3b" or "kimi-linear-48b-a3b"), `dims` (overrides of its
`config.json` keys, for small test models), `compute_dtype` ("bfloat16" on
the card, "float32" on the CPU). Weights: `{model_cache_dir}/<model>/` (the
checkpoint's safetensors shards) or `<model>.pt` (a state dict), in the
checkpoint's key names; random weights otherwise. The tokenizer is a
stand-in (`models/llm/tokenizer.py`) until the models' tokenizer file (one
for both) is on the machine.

Rows: one per section, {"payload": {"start_ms", "end_ms", "text",
"token_ids"}, "span_start_ms", "span_end_ms"}.

Spans (under the task's root): `load_model`, `chapters.sections`,
`llm.prefill` (ends at the job's one synchronisation), `llm.decode` (ends
at the copy of the emitted ids). Counters: `llm_sections`,
`llm_prompt_tokens` (real tokens), `llm_decode_steps`, `llm_decode_rows`
(rows x steps), `moe_token_slots` (token-expert pairs routed, summed over
the expert layers) and `moe_experts_hit` (experts given at least one token,
summed over the expert-layer calls; counted on the device, read once a
task); Kimi-Linear's prefill adds `kda_chunks` and `kda_state_bytes`.
"""
from __future__ import annotations

import bisect
import glob
import json
import logging
import math
import os
from contextlib import nullcontext
from functools import lru_cache
from itertools import accumulate

import torch

from eioku_tpu_torch.models.llm import kimi_linear as kimi
from eioku_tpu_torch.models.llm import model as llm
from eioku_tpu_torch.models.llm.tokenizer import StandInTokenizer
from eioku_tpu_torch.utils.device import resolve_device
from eioku_tpu_torch.utils.metrics import METRICS

log = logging.getLogger(__name__)

DEFAULT_MODEL = "moonlight-16b-a3b"
INSTRUCTION = ("Write one chapter of this recording's table of contents: a short title, then "
               "two or three sentences that summarise the part of the transcript below.")
CUE = "Chapter:"
WHOLE_INSTRUCTION = ("Write this recording's table of contents from its whole transcript below: "
                     "one line a chapter, its start as [h:mm:ss], then a short title.")
WHOLE_CUE = "Chapters:"
EOS_CHECK_STEPS = 16
# rows of a batch, and of every decode graph on the card: a batch's padding
# rows copy its first row, so they route to its experts and add little to
# a step's bytes
DECODE_ROWS = 8
LENGTH_BUCKET = 1024  # a decode graph's cache length is a multiple of this


def _checkpoint(path: str):
    """A checkpoint's tensors in its own key names: from a directory of
    safetensors shards, (name, tensor) pairs read tensor by tensor; from a
    torch state dict file, the mapping (memory-mapped)."""
    if os.path.isdir(path):
        from safetensors import safe_open

        def pairs():
            for shard in sorted(glob.glob(os.path.join(path, "*.safetensors"))):
                with safe_open(shard, "pt") as f:
                    for key in f.keys():
                        yield key, f.get_tensor(key)
        return pairs()
    return torch.load(path, map_location="cpu", mmap=True, weights_only=True)


def load_moonlight_checkpoint(path: str, cfg: llm.MoonlightConfig, dtype: torch.dtype,
                              device) -> llm.Moonlight:
    return llm.load_state_dict(llm.empty_model(cfg, dtype, device), _checkpoint(path))


def load_kimi_linear_checkpoint(path: str, cfg: kimi.KimiLinearConfig, dtype: torch.dtype,
                                device) -> kimi.KimiLinear:
    return kimi.load_state_dict(kimi.empty_model(cfg, dtype, device), _checkpoint(path))


def _family(model_type: str):
    """(config class, model module, checkpoint loader) of a `model_type`."""
    if model_type == "deepseek_v3":
        return llm.MoonlightConfig, llm, load_moonlight_checkpoint
    if model_type == "kimi_linear":
        return kimi.KimiLinearConfig, kimi, load_kimi_linear_checkpoint
    raise ValueError(f"unsupported language model type {model_type!r}")


@lru_cache(maxsize=1)
def _load_model(name: str, dims: str, cache_dir: str | None, compute_dtype: str,
                device: torch.device):
    """The named model (its sizes overridden by the JSON `dims`), loaded
    once per process."""
    if name not in llm.MODELS:
        raise ValueError(f"unknown language model {name!r}; known: {sorted(llm.MODELS)}")
    keys = {**llm.MODELS[name], **json.loads(dims)}
    config, module, load = _family(keys["model_type"])
    cfg = config.from_dict(keys)
    dtype = getattr(torch, compute_dtype)
    for cand in ([os.path.join(cache_dir, name), os.path.join(cache_dir, name + ".pt")]
                 if cache_dir else []):
        if os.path.exists(cand):
            log.info("loading %s", cand)
            return load(cand, cfg, dtype, device)
    log.warning("no %s checkpoint in %s: random weights", name, cache_dir)
    return module.init_random(cfg, dtype, device)


def _mark(ms: int) -> str:
    s = int(ms) // 1000
    return f"[{s // 60:02d}:{s % 60:02d}]"


def _hour_mark(ms: int) -> str:
    s = int(ms) // 1000
    return f"[{s // 3600}:{s // 60 % 60:02d}:{s % 60:02d}]"


def split_sections(segments: list[dict], tokenizer: StandInTokenizer,
                   section_tokens: int, mark=_mark) -> list[dict]:
    """The transcript's rows cut at segment boundaries into the fewest
    near-equal sections of at most `section_tokens` tokens (a single
    longer segment stands alone): [{"start_ms", "end_ms", "text",
    "tokens"}], the text one `[mm:ss] text` line a segment."""
    lines = []
    for row in segments:
        p = row.get("payload", row)
        start = int(row.get("span_start_ms", p.get("start_ms", 0)))
        end = int(row.get("span_end_ms", p.get("end_ms", start)))
        lines.append((start, end, f"{mark(start)} {p.get('text', '').strip()}"))
    if not lines:
        return []
    cum = list(accumulate((len(tokenizer.encode(t)) for _, _, t in lines), initial=0))
    total = cum[-1]
    n = min(max(1, math.ceil(total / section_tokens)), len(lines))
    while True:
        cuts = [0]
        for k in range(1, n):
            target = k * total / n
            b = bisect.bisect_left(cum, target)
            if b > 0 and target - cum[b - 1] < cum[min(b, len(lines))] - target:
                b -= 1
            cuts.append(min(max(b, cuts[-1] + 1), len(lines) - (n - k)))
        cuts.append(len(lines))
        over = any(cum[b] - cum[a] > section_tokens and b - a > 1 for a, b in zip(cuts, cuts[1:]))
        if not over or n == len(lines):
            break
        n += 1
    return [{"start_ms": lines[a][0], "end_ms": lines[b - 1][1],
             "text": "\n".join(t for _, _, t in lines[a:b]), "tokens": cum[b] - cum[a]}
            for a, b in zip(cuts, cuts[1:])]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, prompts: list[list[int]], max_new_tokens: int, stop_at_eos: bool,
             width: int = 0, cache_tokens: int = 0) -> list[list[int]]:
    """Greedy generation of a batch of prompts at once: one prefill (the rows
    right-padded, the first id from its logits), then a decode step of all
    rows a position, each row at its own, until `max_new_tokens` ids a row.
    On the card the rows are padded to `width` with copies of the first
    (they route to its experts) and the cache's length rounded up to
    LENGTH_BUCKET (or `cache_tokens`, if longer), and each step replays the
    CUDA graph of that shape. The loop reads nothing back from the device
    except, with `stop_at_eos`, whether every row has emitted EOS, every
    `EOS_CHECK_STEPS` steps; the rows are then cut before their EOS."""
    dev, cfg = model.device, model.cfg
    fam = kimi if isinstance(model, kimi.KimiLinear) else llm
    rows, lengths = len(prompts), [len(p) for p in prompts]
    eos, steps = cfg.eos_token_id, max_new_tokens - 1
    length = max(lengths) + steps
    if dev.type == "cuda" and steps > 0:
        width = max(width, rows)
        length = max(min(-(-length // LENGTH_BUCKET) * LENGTH_BUCKET, cfg.context_length),
                     min(cache_tokens, cfg.context_length))
        holder = fam.decode_graph(model, width, length, steps)
    else:
        width, holder = rows, nullcontext()
    with holder as graph:
        cache = fam.make_cache(model, width, length, steps) if graph is None else graph.buffers
        cache.reset()
        with METRICS.span("llm.prefill"):
            ids = torch.tensor([t for p in prompts for t in p], device=dev)
            logits = fam.prefill(model, ids, lengths, cache)
            cache.copy_first_row(rows)
            out = torch.empty(width, max_new_tokens, dtype=torch.long, device=dev)
            out[:rows, 0] = logits.argmax(-1)
            out[rows:, 0] = out[0, 0]
            _sync(dev)
        done = 0
        with METRICS.span("llm.decode"):
            pos = torch.tensor(lengths + lengths[:1] * (width - rows), device=dev)
            for t in range(1, max_new_tokens):
                logits = fam.decode_step(model, out[:, t - 1], pos, cache)
                out[:, t] = logits.argmax(-1)
                pos += 1
                done += 1
                if stop_at_eos and t % EOS_CHECK_STEPS == 0 and \
                        bool((out[:rows, :t + 1] == eos).any(1).all()):
                    break
            emitted = out[:rows, :done + 1].tolist()
        experts_hit = cache.experts_hit(rows, done)
    moe_layers = sum(not layer.dense for layer in model.layers)
    METRICS.count("llm_prompt_tokens", sum(lengths))
    METRICS.count("llm_decode_steps", done)
    METRICS.count("llm_decode_rows", rows * done)
    METRICS.count("moe_token_slots",
                  (sum(lengths) + rows * done) * cfg.num_experts_per_tok * moe_layers)
    METRICS.count("moe_experts_hit", experts_hit)
    if stop_at_eos:
        emitted = [r[:r.index(eos)] if eos in r else r for r in emitted]
    return emitted


def run_summarization(video_path: str, config: dict, model_cache_dir: str | None = None,
                      device: str | torch.device | None = None) -> list[dict]:
    """The task: chapters of the transcript in `config["segments"]`
    (`video_path` names the recording and is not read)."""
    dev = resolve_device(device)
    compute = config.get("compute_dtype", "bfloat16" if dev.type == "cuda" else "float32")
    with METRICS.span("load_model"):
        model = _load_model(config.get("model", DEFAULT_MODEL),
                            json.dumps(config.get("dims", {}), sort_keys=True), model_cache_dir,
                            compute, dev)
    cfg = model.cfg
    tok = StandInTokenizer(cfg.vocab_size, cfg.bos_token_id, cfg.eos_token_id)
    if isinstance(model, kimi.KimiLinear):
        return _whole_chapters(model, tok, config)
    with METRICS.span("chapters.sections"):
        sections = split_sections(config.get("segments") or [], tok,
                                  int(config.get("section_tokens", 2048)))
        head, cue = [tok.bos_id] + tok.encode(INSTRUCTION), tok.encode(CUE)
        prompts = [head + tok.encode(s["text"]) + cue for s in sections]
    if not sections:
        return []
    METRICS.count("llm_sections", len(sections))
    emitted = []
    for i in range(0, len(prompts), DECODE_ROWS):
        emitted += generate(model, prompts[i:i + DECODE_ROWS],
                            int(config.get("max_new_tokens", 192)),
                            bool(config.get("stop_at_eos", True)), DECODE_ROWS)
    return [{"payload": {"start_ms": s["start_ms"], "end_ms": s["end_ms"],
                         "text": tok.decode(ids), "token_ids": ids},
             "span_start_ms": s["start_ms"], "span_end_ms": s["end_ms"]}
            for s, ids in zip(sections, emitted)]


def _whole_chapters(model: kimi.KimiLinear, tok: StandInTokenizer, config: dict) -> list[dict]:
    """Kimi-Linear's chapters: the whole transcript as one prompt, decoded
    as one row; one row for the recording."""
    with METRICS.span("chapters.sections"):
        whole = split_sections(config.get("segments") or [], tok, math.inf, _hour_mark)
    if not whole:
        return []
    s = whole[0]
    METRICS.count("llm_sections", 1)
    prompt = ([tok.bos_id] + tok.encode(WHOLE_INSTRUCTION) + tok.encode(s["text"])
              + tok.encode(WHOLE_CUE))
    ids = generate(model, [prompt], int(config.get("max_new_tokens", 128)),
                   bool(config.get("stop_at_eos", True)), 1,
                   int(config.get("cache_tokens", 0)))[0]
    return [{"payload": {"start_ms": s["start_ms"], "end_ms": s["end_ms"],
                         "text": tok.decode(ids), "token_ids": ids},
             "span_start_ms": s["start_ms"], "span_end_ms": s["end_ms"]}]
