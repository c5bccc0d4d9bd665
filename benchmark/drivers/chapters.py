"""Closed-loop chapter jobs on one worker: one recording's transcript after
another, each `InferenceEngine.run_task("summarization", ...)`, as an
indexing worker would chapter them after transcription. This module is
Moonlight-16B-A3B's part of the closed loop (`closed_loop.py` runs it; its
interface is described there).

The jobs are the transcripts' rows as `transcription` returns them, in JSON
files: pseudo-words drawn by Zipf's law from a fixed list, at the traffic's
tokens per audio second, in segments of 1-6 s. The segment lengths and
word counts are the same for every seed (so every seed does the same
work); the seed draws the words. Set-up hands the port's own loader
(`load_state_dict`, through `ml/summarize.py`'s checkpoint entry) the
seeded bf16 weights in the checkpoint's key names, one layer at a time,
so that no second copy of the model is held, then runs one warm-up job of
six sections, the most rows any job has, and `warmup_passes` whole passes
over the window's jobs: every prompt shape of the eager prefill is then
warm, and the window does not open on the card's first seconds of work
after the weights load, which ran 0-13% slower than the passes after
them (PERF.md §7).

`correct` compares what the window's own jobs produced, on sections drawn
by a seeded reservoir: the port's logits at each kept section's last
prompt position and at a few decode steps (`check_steps`), and each token
it emitted, against the float32 reference's full causal forward over the
prompt and the port's emitted tokens (no cache), run once the port is
released: prefill, then decode through the latent cache, held against one
full pass; and the port's routing on its own router inputs.
- `logit_err`: the largest, over the compared positions, of max |port -
  reference| / std(reference) over the vocabulary;
- `tok_gap` (nats): the largest gap between the reference's best
  log-probability and its log-probability of the token the port emitted,
  over every emitted token;
- `route_gap`: teacher-forced routing. The reference routes the port's own
  router inputs (each kept section's prompt tokens, every expert layer)
  in float32 and reads how far below its k-th best choice score (sigmoid
  score plus correction bias) the port's chosen experts lie: 0 unless a
  chosen expert is not among the reference's top k. Rounding of the same
  inputs cannot move a choice score past float32's own rounding; a router
  fault can (a bias at half scale reads ~0.09, a gate in bf16 ~1e-3).
"""
from __future__ import annotations

import gc
import json
import math
import os
import shutil
import sys
import time

import numpy as np
import torch

from benchmark import harness, roofline
from benchmark import weights as bench_weights
from benchmark.drivers import closed_loop
from benchmark.reference import moonlight as ref_moonlight
from benchmark.reference.precision import Arith

RATE = "audio_s_per_s"
CHECKED = ("logit_err", "tok_gap", "route_gap")
COMPARED = "positions"
# the configuration file's keys that are not the model's `config.json`
_NOT_MODEL = {"name", "source", "reduced", "deployment", "assumed", "job", "limits", "rehearse"}


def dims_of(model_cfg: dict) -> dict:
    """The model's `config.json` keys from the configuration file."""
    return {k: v for k, v in model_cfg.items() if k not in _NOT_MODEL}


# -- traffic ------------------------------------------------------------------------


def pseudo_words(n: int) -> list[str]:
    """A fixed list of n distinct pseudo-words of two to four syllables."""
    onsets, vowels, codas = "bdfgklmnprstvz", "aeiou", ["", "n", "r", "s"]
    syl = [o + v + c for o in onsets for v in vowels for c in codas]  # 280
    out = []
    for i in range(n):
        k, word = i, ""
        for _ in range(2 + i % 3):
            word += syl[k % len(syl)]
            k //= len(syl)
        out.append(word)
    return out


def transcript(duration_s: float, rng: np.random.Generator, p: dict) -> list[dict]:
    """Transcript rows over `duration_s` seconds: segments of `segment_s`
    seconds (their lengths from a fixed draw), each with round(tokens_per_s
    x its length) - 1 words (its `[mm:ss]` mark is the last token), the
    words drawn from `rng` by Zipf's law over `words` pseudo-words."""
    layout = np.random.default_rng([int(duration_s * 1000), 23])  # the same for every seed
    vocab = pseudo_words(int(p["words"]))
    zipf = 1.0 / np.arange(1, len(vocab) + 1) ** float(p["zipf_s"])
    zipf /= zipf.sum()
    rows, t, end = [], 0, int(duration_s * 1000)
    while t < end:
        d = min(int(layout.uniform(*p["segment_s"]) * 1000), end - t)
        n = max(1, round(float(p["tokens_per_s"]) * d / 1000) - 1)
        words = rng.choice(len(vocab), size=n, p=zipf)
        rows.append({"payload": {"text": " ".join(vocab[w] for w in words), "language": "en",
                                 "start_ms": t, "end_ms": t + d},
                     "span_start_ms": t, "span_end_ms": t + d})
        t += d
    return rows


def write_jobs(folder: str, seed: int, traffic: dict) -> tuple[str, list[tuple[str, float]]]:
    """The warm-up job and the window's jobs as JSON files of transcript rows,
    and the warm-up's plan (`warmup.json`: the warm-up job's path, then the
    window's jobs `warmup_passes` times over). Returns (the plan's path,
    [(path, audio seconds)])."""
    shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder)
    rng = np.random.default_rng([seed, 29])
    paths = []
    for i, dur in enumerate([traffic["warmup_s"]] + list(traffic["durations_s"])):
        path = os.path.join(folder, f"job{i:02d}.json")
        with open(path, "w") as f:
            json.dump(transcript(float(dur), rng, traffic), f)
        paths.append((path, float(dur)))
    plan = os.path.join(folder, "warmup.json")
    window = [p for p, _ in paths[1:]]
    with open(plan, "w") as f:
        json.dump({"jobs": [paths[0][0]] + window * int(traffic["warmup_passes"])}, f)
    return plan, paths[1:]


# -- seeded weights -------------------------------------------------------------------------


def _kind(name: str, shape: tuple[int, ...]) -> str:
    if name in ("model.embed_tokens.weight", "lm_head.weight"):
        return "token"
    if name.endswith("e_score_correction_bias"):
        return "bias"
    return "linear" if len(shape) == 2 else "ln_weight"


BIAS_SCALE = 5.0  # the correction bias: 5 x the uniform +-0.02 of a bias, so +-0.1
RESIDUAL_OUT = ("o_proj.weight", "down_proj.weight")  # the matrices that end a residual branch
Q_SCALE = 2.0  # q_proj: attention scores of std ~1.5 where xavier gives ~0.7


def part_weights(dims: dict, seed: int, part, device) -> dict[str, torch.Tensor]:
    """One part's seeded bf16 tensors (`reference.moonlight.parts`: the
    embedding, a layer, the head), each part its own draw of
    `weights.seeded_state_dict` from (seed, part): xavier-uniform matrices,
    norms near 1, token rows of std 1/sqrt(d) (logits spread by about 1)
    and a correction bias of +-0.1, the order of the spread of the 64
    sigmoid scores, so that it decides many of the choices. The matrices
    that end a residual branch are scaled by 1/sqrt(2 x layers), as GPT-2's
    and Megatron's initialisations scale them: with branches of unit gain,
    27 layers amplify rounding as no trained model does. q_proj is doubled:
    xavier weights spread the attention scores by ~0.7, nearly uniform over
    1.8k keys, where a trained model's attention picks positions out (and a
    cache entry at the wrong position would not show)."""
    shapes = [(n, s, _kind(n, s)) for n, s in ref_moonlight.layer_shapes(dims, part)]
    index = ref_moonlight.parts(dims).index(part)
    out = bench_weights.seeded_state_dict(shapes, seed * 64 + index, device, torch.bfloat16,
                                          token_std=1.0 / math.sqrt(dims["hidden_size"]))
    for name, t in out.items():
        if name.endswith("e_score_correction_bias"):
            t.mul_(BIAS_SCALE)
        elif name.endswith(RESIDUAL_OUT):
            t.mul_(1.0 / math.sqrt(2 * dims["num_hidden_layers"]))
        elif name.endswith("q_proj.weight"):
            t.mul_(Q_SCALE)
    return out


# -- the port ---------------------------------------------------------------------------


class Port:
    """The port's summarization entry, fed the benchmark's seeded weights."""

    def __init__(self, model_cfg: dict, device: str, cache: str):
        from eioku_tpu_torch.ml import summarize
        from eioku_tpu_torch.ml.engine import InferenceEngine
        from eioku_tpu_torch.models.llm import model as llm

        self.summarize = summarize
        self.dims = dims_of(model_cfg)
        self.job = {**model_cfg["job"], "dims": self.dims}
        self.device = device
        self.seed: int | None = None
        self.cold = True
        os.makedirs(cache, exist_ok=True)
        # with this file present the entry takes its checkpoint path; the
        # tensors come from the seed, not from the file
        open(os.path.join(cache, model_cfg["job"]["model"] + ".pt"), "wb").close()
        self._loader = summarize.load_moonlight_checkpoint

        def from_memory(path, cfg, dtype, dev):
            model = llm.empty_model(cfg, dtype, dev)

            def pairs():  # one part's draw at a time
                for part in ref_moonlight.parts(self.dims):
                    yield from part_weights(self.dims, self.seed, part, dev).items()
            llm.load_state_dict(model, pairs())
            if self.device != "cpu":
                harness.log(f"weights loaded: {torch.cuda.memory_allocated() / 1e9:.2f} GB held, "
                            f"set-up peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            return model
        summarize.load_moonlight_checkpoint = from_memory
        self.engine = InferenceEngine(model_cache_dir=cache, device=device)

    def give(self, seed: int) -> None:
        """The seed's weights for the entry's next load (its cache cleared)."""
        self.forget()
        self.seed = seed
        self.cold = True

    def run(self, path: str):
        """One job; or the warm-up's plan: its first job, and the first time
        after `give` every job it lists (the profiler's slice runs the first
        alone)."""
        with open(path) as f:
            rows = json.load(f)
        if isinstance(rows, dict):
            plan = rows["jobs"] if self.cold else rows["jobs"][:1]
            self.cold = False
            return [self.run(p) for p in plan][-1]
        return self.engine.run_task("summarization", path, {**self.job, "segments": rows})

    def forget(self) -> None:
        self.summarize._load_model.cache_clear()
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def close(self) -> None:
        self.forget()
        self.summarize.load_moonlight_checkpoint = self._loader


# -- the window's sections, for the check ------------------------------------------------------


class SectionCapture(closed_loop.Reservoir):
    """Wrappers on the model's prefill, decode step and routing and on the
    task's generation that keep, for a seeded reservoir of `keep` sections,
    the prompt, the emitted ids, the logits the port computed at the last
    prompt position and at the decode steps `steps`, the experts it routed
    each token to in each expert layer (the prefill's from its routing
    calls, the decode steps' from the cache's route log) and the prefill's
    router inputs of its prompt. References to the port's own outputs (each
    call returns new ones), except where holding them would pin memory:
    one copy a job of the route log, which a decode graph's next generation
    reuses (1.9 MB on the card), and a kept section's router inputs, copied
    into its reservoir slot (`slots` [keep, expert layers, tokens, d],
    allocated before the window): holding its job's (up to 1.2 GB on the
    card) across jobs came with prefill stalls of up to 2.8 s (PERF.md §6).
    No synchronisation on the timed path. Each job's
    start on the wall clock is kept for the run's log."""

    def __init__(self, seed: int, keep: int, steps: list[int], slots: torch.Tensor):
        super().__init__(seed, keep)
        self.steps = set(steps)
        self.slots = slots
        self.logits: dict[int, torch.Tensor] = {}
        self.routes: list[torch.Tensor] = []
        self.inputs: list[torch.Tensor] = []
        self.starts: list[float] = []
        self.cache = None
        self.in_prefill = False
        self.step = 0
        self.jobs = 0

    def install(self, spans: harness.Spans, summarize, llm) -> None:
        prefill_fn, step_fn, route_fn, gen_fn = (llm.prefill, llm.decode_step, llm.route,
                                                 summarize.generate)

        def prefill(model, ids, lengths, cache):
            self.in_prefill, self.cache = True, cache
            try:
                out = prefill_fn(model, ids, lengths, cache)
            finally:
                self.in_prefill = False
            self.step = 0
            if self.on:
                self.logits[0] = out
            return out

        def step(*a, **kw):
            out = step_fn(*a, **kw)
            self.step += 1
            if self.on and self.step in self.steps:
                self.logits[self.step] = out
            return out

        def route(layer, cfg, x):
            w, chosen = route_fn(layer, cfg, x)
            if self.on and self.in_prefill:
                self.routes.append(chosen)
                self.inputs.append(x)
            return w, chosen

        def generate(model, prompts, *a, **kw):
            if self.on:
                self.starts.append(time.time())
            out = gen_fn(model, prompts, *a, **kw)
            if self.on:
                self.jobs += 1
                decode_routes, offset = self.cache.routes.clone(), 0
                for r, (prompt, emitted) in enumerate(zip(prompts, out)):
                    rec = {"prompt": prompt, "emitted": emitted, "row": r, "offset": offset,
                           "logits": self.logits, "prefill_routes": self.routes,
                           "decode_routes": decode_routes}
                    self.offer(rec)
                    self.keep_inputs(rec)
                    offset += len(prompt)
            self.logits, self.routes, self.inputs = {}, [], []
            return out
        spans.patch(llm, "prefill", prefill)
        spans.patch(llm, "decode_step", step)
        spans.patch(llm, "route", route)
        spans.patch(summarize, "generate", generate)

    def keep_inputs(self, rec: dict) -> None:
        """If the reservoir kept the section, its rows of the job's router
        inputs, copied into its slot: rec["router_inputs"] [expert layers,
        prompt, d] (a copy of its own where the prompt is longer)."""
        j = next((i for i, k in enumerate(self.kept) if k is rec), None)
        if j is None:
            return
        length = len(rec["prompt"])
        rows = slice(rec["offset"], rec["offset"] + length)
        if length > self.slots.shape[2]:
            rec["router_inputs"] = torch.stack([x[rows] for x in self.inputs])
            return
        dst = self.slots[j, :, :length]
        for m, x in enumerate(self.inputs):
            dst[m].copy_(x[rows])
        rec["router_inputs"] = dst

    def describe(self) -> str:
        from eioku_tpu_torch.utils.metrics import METRICS

        tasks = [t for t in METRICS.recent_tasks() if t["type"] == "summarization"][-self.jobs:]
        hit, slots = (sum(t["counters"].get(k, 0) for t in tasks)
                      for k in ("moe_experts_hit", "moe_token_slots"))
        spans = [[round(t["spans"].get(k, {}).get("total_ns", 0) / 1e6, 1)
                  for k in ("llm.prefill", "llm.decode")] for t in tasks]
        line = (f"sections: {self.seen} in {self.jobs} jobs offered to the check, "
                f"{len(self.kept)} kept; experts hit over the window's expert-layer calls "
                f"{hit:.0f}, token-expert pairs {slots:.0f}; ms of prefill and decode a job "
                f"{spans}; each job's start, Unix s {[round(t, 3) for t in self.starts]}")
        if self.slots.is_cuda:
            m = torch.cuda.memory_stats()
            line += (f"; the process's allocator: {m.get('num_alloc_retries', 0)} retries after "
                     f"freeing its cache, {m.get('num_device_alloc', 0)} device allocations, "
                     f"{m.get('num_device_free', 0)} frees, reserved peak "
                     f"{m.get('reserved_bytes.all.peak', 0) / 1e9:.2f} GB")
        return line


SLOT_SLACK = 256  # prompt tokens past `section_tokens` a slot holds: the instruction and cue


def install_capture(spans: harness.Spans, port: Port, seed: int,
                    traffic: dict) -> SectionCapture:
    from eioku_tpu_torch.models.llm import model as llm

    keep, d = int(traffic["check_sections"]), port.dims["hidden_size"]
    layers = port.dims["num_hidden_layers"] - port.dims["first_k_dense_replace"]
    slots = torch.empty(keep, layers, int(port.job["section_tokens"]) + SLOT_SLACK, d,
                        dtype=getattr(torch, port.job["compute_dtype"]), device=port.device)
    capture = SectionCapture(seed, keep, list(traffic["check_steps"]), slots)
    capture.install(spans, port.summarize, llm)
    return capture


# -- the check ------------------------------------------------------------------------------


# choice scores (sigmoid plus bias) this close to the k-th best, on the
# reference's own hidden states, are the drift's to decide: the reference
# takes the program's expert there (the routing itself is held to float32
# on the program's own inputs, `route_gap`)
AMBIGUITY = 0.05


def readings(kept: list[dict], ref: list[torch.Tensor], control: list[torch.Tensor] | None = None,
             ref_c: list[torch.Tensor] | None = None) -> dict:
    """The numbers `correct` compares, from the reference's logits at each
    kept section's emitted positions (`ref[j]` [len(emitted), V]: position
    t predicts emitted token t): logit_err over the positions whose port
    logits were kept, tok_gap over every emitted token. With `control` (the
    reference in float8) and `ref_c` (the float32 reference that followed
    the control's near-tie choices), the control's numbers in the program's
    place under "control": its logits against ref_c's, ref_c's gap to the
    control's own best token."""
    out = {"logit_err": 0.0, "tok_gap": 0.0, "route_gap": 0.0, "positions": 0, "tokens": 0}
    ctl = {"logit_err": 0.0, "tok_gap": 0.0}

    def gap_of(r: torch.Tensor, chosen: torch.Tensor) -> float:
        lp = r.float().log_softmax(-1)
        n = chosen.shape[0]
        return float((lp.max(-1).values[:n] - lp[torch.arange(n, device=lp.device),
                                                   chosen.to(lp.device)]).max())

    def err_of(got: torch.Tensor, r: torch.Tensor) -> float:
        return float((got.to(r.device).float() - r).abs().max() / r.std())

    for j, rec in enumerate(kept):
        r = ref[j].float()
        n = min(len(rec["emitted"]), r.shape[0])
        out["tok_gap"] = max(out["tok_gap"], gap_of(r, torch.tensor(rec["emitted"][:n])))
        out["tokens"] += n
        for t, logits in rec["logits"].items():
            if t < n:
                out["logit_err"] = max(out["logit_err"], err_of(logits[rec["row"]], r[t]))
                out["positions"] += 1
                if control is not None:
                    ctl["logit_err"] = max(ctl["logit_err"], err_of(control[j][t], ref_c[j][t]))
        if control is not None:
            ctl["tok_gap"] = max(ctl["tok_gap"], gap_of(ref_c[j], control[j][:n].argmax(-1)))
    if control is not None:
        out["control"] = ctl
    return out


def port_routes(rec: dict, dims: dict):
    """The experts the port routed a kept section's tokens to, by layer:
    layer i -> [prompt + emitted - 1, k] (its prefill rows, then its row of
    the decode steps' route log)."""
    first = dims["first_k_dense_replace"]
    length, steps = len(rec["prompt"]), len(rec["emitted"]) - 1

    def layer(i: int) -> torch.Tensor:
        j = i - first
        prompt = rec["prefill_routes"][j][rec["offset"]:rec["offset"] + length]
        return torch.cat([prompt, rec["decode_routes"][j, rec["row"], :steps]])
    return layer


def port_router_inputs(rec: dict, dims: dict):
    """The port's router inputs of a kept section's prompt tokens and the
    experts it chose from them, by layer: layer i -> ([prompt, d], [prompt,
    k])."""
    first = dims["first_k_dense_replace"]
    rows = slice(rec["offset"], rec["offset"] + len(rec["prompt"]))

    def layer(i: int) -> tuple[torch.Tensor, torch.Tensor]:
        j = i - first
        return rec["router_inputs"][j], rec["prefill_routes"][j][rows]
    return layer


def check(kept: list[dict], model_cfg: dict, seed: int, device, control: bool = False) -> dict:
    """`readings` of the kept sections against the float32 reference's full
    forward over prompt plus emitted tokens, on the seed's weights, the port's
    near-tie expert choices followed, and the port's routing of its own
    router inputs routed again (`route_gap`); with `control`, the reference
    in float8 as well, against a float32 reference that follows its choices
    and routes its router inputs again. Built one part at a time."""
    dims = dims_of(model_cfg)
    if not kept:
        return readings([], [])
    seqs = [rec["prompt"] + rec["emitted"][:-1] for rec in kept]
    positions = [list(range(len(rec["prompt"]) - 1, len(s))) for rec, s in zip(kept, seqs)]
    follows = [port_routes(rec, dims) for rec in kept]
    forced = [port_router_inputs(rec, dims) for rec in kept]
    ref = ref_moonlight.Moonlight(dims, Arith(), lambda s, i: follows[s](i), AMBIGUITY,
                                  lambda s, i: forced[s](i))
    models = [ref]
    if control:
        ctl = ref_moonlight.Moonlight(dims, Arith("fp8"), keep_inputs=True)
        models += [ctl, ref_moonlight.Moonlight(
            dims, Arith(), lambda s, i: ctl.chosen[(s, i)], AMBIGUITY,
            lambda s, i: (ctl.inputs.pop((s, i)), ctl.chosen[(s, i)]))]
    out = ref_moonlight.logits(dims, lambda part: part_weights(dims, seed, part, device), seqs,
                               positions, models, device)
    r = readings(kept, out[0], *(out[1:] if control else ()))
    r.update(route_gap=ref.forced_gap, routed_again=ref.forced_tokens, route_drift=ref.drift,
             routes_followed=ref.followed)
    if control:
        r["control"].update(route_gap=models[2].forced_gap, route_drift=models[2].drift)
    return r


# -- the traced run ------------------------------------------------------------------------


def token_flops(dims: dict, keys: int, logits: bool) -> float:
    """The published math of one token through the model, attending over
    `keys` positions (its own included): per layer the projections (q,
    kv_a, kv_b's decompression of its latent, o), attention (qk 192 and v
    128 a head), then the dense MLP or the router, the top-k routed experts
    and the shared experts; `lm_head` if its logits are used."""
    d, h = dims["hidden_size"], dims["num_attention_heads"]
    nope, rope, vd, lora = (dims["qk_nope_head_dim"], dims["qk_rope_head_dim"],
                            dims["v_head_dim"], dims["kv_lora_rank"])
    attn = 2 * d * (h * (nope + rope) + lora + rope) + 2 * lora * h * (nope + vd) \
        + 2 * h * vd * d + 2 * h * (nope + rope + vd) * keys
    dense = 2 * 3 * d * dims["intermediate_size"]
    m = dims["moe_intermediate_size"]
    sparse = 2 * d * dims["n_routed_experts"] \
        + 2 * 3 * d * m * (dims["num_experts_per_tok"] + dims["n_shared_experts"])
    n_dense = dims["first_k_dense_replace"]
    layers = dims["num_hidden_layers"]
    return layers * attn + n_dense * dense + (layers - n_dense) * sparse \
        + (2 * d * dims["vocab_size"] if logits else 0)


def prefill_flops(dims: dict, length: int) -> float:
    """A prompt of `length` tokens: token i attends over i + 1 positions;
    logits at the last one only."""
    per = token_flops(dims, 0, False) * length
    attn = 2 * dims["num_attention_heads"] * (dims["qk_nope_head_dim"] + dims["qk_rope_head_dim"]
                                              + dims["v_head_dim"])
    return per + dims["num_hidden_layers"] * attn * length * (length + 1) / 2 \
        + 2 * dims["hidden_size"] * dims["vocab_size"]


def expert_bound_s(dims: dict, routed: int, hit: int) -> float:
    """The least time of one expert layer's GEMMs: `routed` token-expert
    pairs through gate, up and down at the bf16 peak, or `hit` experts'
    weights read once plus the tokens in and out at the bandwidth."""
    d, m = dims["hidden_size"], dims["moe_intermediate_size"]
    flops = 2 * 3 * d * m * routed
    bytes_ = hit * 3 * d * m * 2 + routed * d * 2 * 2
    return max(flops / roofline.PEAK_FLOPS["bfloat16"], bytes_ / roofline.PEAK_BYTES_PER_S)


_TRACE: dict = {}  # the traced run's state, read by layer_readings


def trace_wrappers(spans: harness.Spans, traffic: dict, model_cfg: dict) -> dict:
    """The traced run's wrappers, around the capture's: a synchronised span
    of each job's generation (the marks by which the window's task records
    are found); the useful operations from shapes (`useful_flops`); and the
    profiler's slice, armed by the returned state: it starts at the next
    prefill and stops after the traffic's `profile_decode_steps` decode
    steps. The expert GEMMs' bound over the slice (traced run only, read on
    the host once the profiler has stopped): the prefill's from each
    expert-layer call's group ends (kept on the device until then), the
    decode steps' from the cache's route log (every row of the batch, the
    padding rows included, as the grouped GEMMs run them)."""
    from torch.profiler import ProfilerActivity, profile

    from eioku_tpu_torch.ml import summarize
    from eioku_tpu_torch.models.llm import model as llm

    dims = dims_of(model_cfg)
    profile_steps = int(traffic["profile_decode_steps"])
    st = {"armed": False, "prof": None, "done": None, "steps": 0, "t0": 0.0, "slice_s": 0.0,
          "lengths": [], "step": 0, "in_prefill": False, "moe_bound_s": 0.0, "moe_calls": 0,
          "ends": [],
          "what": f"one job's prefill and its first {profile_steps} decode steps"}
    _TRACE.clear()
    _TRACE.update(st=st)
    c = spans.counters
    spans.wrap(summarize, "generate", "generate")
    prefill_fn, step_fn, experts_fn = llm.prefill, llm.decode_step, llm.routed_experts

    def prefill(model, ids, lengths, cache):
        if st["armed"]:
            torch.cuda.synchronize()
            st.update(prof=profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]),
                      armed=False, steps=0)
            t = time.perf_counter()
            st["prof"].start()
            st["t0"] = time.perf_counter()  # the slice's wall from its first launch
            harness.log(f"profiler started in {st['t0'] - t:.3f} s")
        st["lengths"], st["step"], st["in_prefill"] = list(lengths), 0, True
        c["useful_flops"] += sum(prefill_flops(dims, n) for n in lengths)
        try:
            return prefill_fn(model, ids, lengths, cache)
        finally:
            st["in_prefill"] = False

    def step(model, tokens, pos, cache):
        st["step"] += 1
        c["useful_flops"] += sum(token_flops(dims, n + st["step"], True) for n in st["lengths"])
        if st["prof"] is None:
            return step_fn(model, tokens, pos, cache)
        with torch.profiler.record_function("bench:decode_step"):
            out = step_fn(model, tokens, pos, cache)
        st["steps"] += 1
        if st["steps"] >= profile_steps:
            torch.cuda.synchronize()
            st["slice_s"] = time.perf_counter() - st["t0"]
            st["prof"].stop()
            st["done"], st["prof"] = st["prof"], None
            calls, st["ends"] = st["ends"], []
            for ends in calls:  # one prefill expert-layer call's group ends
                e = ends.tolist()
                hit = sum(b > a for a, b in zip([0] + e[:-1], e))
                st["moe_bound_s"] += expert_bound_s(dims, e[-1], hit)
                st["moe_calls"] += 1
            for layer in cache.routes[:, :, :profile_steps].transpose(1, 2).tolist():
                for rows in layer:  # one decode step of one expert layer
                    slots = [e for row in rows for e in row]
                    st["moe_bound_s"] += expert_bound_s(dims, len(slots), len(set(slots)))
                    st["moe_calls"] += 1
        return out

    def experts(x, gate_up, down, ends):
        if st["prof"] is not None and st["in_prefill"]:
            st["ends"].append(ends)  # a new tensor each call: a reference, no read
        return experts_fn(x, gate_up, down, ends)
    spans.patch(llm, "prefill", prefill)
    spans.patch(llm, "decode_step", step)
    spans.patch(llm, "routed_experts", experts)
    return st


# -- one run --------------------------------------------------------------------------------


def layer_readings(model_cfg: dict, done: list[tuple[float, float]]) -> dict:
    st = _TRACE.get("st") or {}
    return {"audio_s": sum(a for a, _ in done), "dims": dims_of(model_cfg),
            "moe_bound_s": st.get("moe_bound_s", 0.0), "moe_calls": st.get("moe_calls", 0)}


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        rehearse: bool) -> tuple[dict, dict]:
    """One run of a chapters cell: (result, checks)."""
    return closed_loop.run(sys.modules[__name__], cell, seed, seconds, trace, rehearse)


def calibrate(cell: harness.Cell, seeds: list[int], seconds: float) -> list[dict]:
    """The program's readings and the control's (the reference in float8 in
    its place, at the same positions of the same sequences) on each seed,
    with one set-up: per seed the weights are made and loaded and the
    window runs `seconds`."""
    return closed_loop.calibrate(sys.modules[__name__], cell, seeds, seconds)
