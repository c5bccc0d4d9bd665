"""Closed-loop whole-recording chapter jobs on one worker: one multi-hour
recording's transcript after another, each `InferenceEngine.run_task(
"summarization", ...)` of Kimi-Linear-48B-A3B, the whole transcript as one
prompt decoded as one row. This module is Kimi-Linear's part of the closed
loop (`closed_loop.py` runs it; its interface is described there); the
transcripts are `chapters.py`'s, at this traffic's lengths.

Set-up hands the port's own loader (`ml/summarize.py`'s checkpoint entry,
`models/llm/kimi_linear.py` `load_state_dict`) the seeded bf16 weights in
the checkpoint's key names, one layer at a time: this card's share of a
deployment of expert parallelism over two cards (experts 0-127 of each
expert layer's 256), every other tensor whole. It then runs one warm-up job
of the longest recording and `warmup_passes` whole passes over the
window's jobs.

`correct` compares what the window's own jobs produced, on `check_jobs`
jobs drawn by a seeded reservoir, against the float32 reference
(`reference/kimi_linear.py`) run once the port is released, layer by layer
on the seed's weights: its full causal forward over the prompt and the
port's emitted tokens (KDA over blocks of 64 tokens, MLA over blocks of
queries), against the port's prefill and decode through the hybrid cache.
- `logit_err`: the largest, over the last prompt position and the decode
  steps `check_steps`, of max |port - reference| / std(reference);
- `tok_gap` (nats): the largest gap between the reference's best
  log-probability and that of the token the port emitted, over every
  emitted token;
- `route_gap`: the port's router inputs at `route_tokens` prompt positions
  spread over the whole prompt (every expert layer), routed again in
  float32: the widest gap of a port's chosen expert below the reference's
  k-th best choice score (0 unless a choice differs). Where the
  reference's own hidden states put the port's expert within `AMBIGUITY`
  of its k-th best, it follows the port (`chapters.py`).
"""
from __future__ import annotations

import gc
import json
import math
import os
import sys
import time

import torch

from benchmark import harness
from benchmark import weights as bench_weights
from benchmark.drivers import chapters, closed_loop
from benchmark.reference import kimi_linear as ref_kimi
from benchmark.reference.precision import Arith

RATE = chapters.RATE
CHECKED = chapters.CHECKED
COMPARED = chapters.COMPARED
AMBIGUITY = chapters.AMBIGUITY
dims_of = chapters.dims_of
write_jobs = chapters.write_jobs

# -- seeded weights -------------------------------------------------------------------------


def _kind(name: str, shape: tuple[int, ...]) -> str:
    if name in ("model.embed_tokens.weight", "lm_head.weight"):
        return "token"
    if name.endswith(("e_score_correction_bias", "conv1d.weight", "A_log", "dt_bias")):
        return "bias"  # +-0.02, scaled below
    return "linear" if len(shape) == 2 else "ln_weight"


CONV_SCALE = 25.0  # conv taps +-0.5, PyTorch's default bound for a depthwise conv of 4
DT_SCALE, DT_SHIFT = 100.0, -4.5  # dt_bias in -6.5 .. -2.5: a decay of about 0.82-0.9995 a step


def part_weights(dims: dict, seed: int, part, device) -> dict[str, torch.Tensor]:
    """One part's seeded bf16 tensors (the embedding, a layer, the head),
    each part its own draw of `weights.seeded_state_dict` from (seed,
    part), scaled as `chapters.part_weights` scales Moonlight's (a
    correction bias of +-0.1, the matrices that end a residual branch by
    1/sqrt(2 x layers), q_proj doubled), and KDA's own: conv taps of +-0.5,
    A_log near 0 (exp(A_log) about 1), and dt_bias in -6.5 .. -2.5, so that
    softplus(f + dt_bias), with f of std ~0.3, puts a step's decay alpha
    between about 0.82 and 0.9995."""
    shapes = [(n, s, _kind(n, s)) for n, s in ref_kimi.layer_shapes(dims, part)]
    index = ref_kimi.parts(dims).index(part)
    out = bench_weights.seeded_state_dict(shapes, seed * 64 + index, device, torch.bfloat16,
                                          token_std=1.0 / math.sqrt(dims["hidden_size"]))
    for name, t in out.items():
        if name.endswith("e_score_correction_bias"):
            t.mul_(chapters.BIAS_SCALE)
        elif name.endswith(chapters.RESIDUAL_OUT):
            t.mul_(1.0 / math.sqrt(2 * dims["num_hidden_layers"]))
        elif name.endswith("q_proj.weight"):
            t.mul_(chapters.Q_SCALE)
        elif name.endswith("conv1d.weight"):
            t.mul_(CONV_SCALE)
        elif name.endswith("dt_bias"):
            t.mul_(DT_SCALE).add_(DT_SHIFT)
    return out


# -- the port ---------------------------------------------------------------------------


class Port:
    """The port's summarization entry, fed the benchmark's seeded weights."""

    def __init__(self, model_cfg: dict, device: str, cache: str):
        from eioku_tpu_torch.ml import summarize
        from eioku_tpu_torch.ml.engine import InferenceEngine
        from eioku_tpu_torch.models.llm import kimi_linear as kimi

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
        self._loader = summarize.load_kimi_linear_checkpoint

        def from_memory(path, cfg, dtype, dev):
            model = kimi.empty_model(cfg, dtype, dev)

            def pairs():  # one part's draw at a time
                for part in ref_kimi.parts(self.dims):
                    yield from part_weights(self.dims, self.seed, part, dev).items()
            kimi.load_state_dict(model, pairs())
            if self.device != "cpu":
                harness.log(f"weights loaded: {torch.cuda.memory_allocated() / 1e9:.2f} GB held, "
                            f"set-up peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            return model
        summarize.load_kimi_linear_checkpoint = from_memory
        self.engine = InferenceEngine(model_cache_dir=cache, device=device)

    def give(self, seed: int) -> None:
        self.forget()
        self.seed = seed
        self.cold = True

    def run(self, path: str):
        """One job; or the warm-up's plan (its first job, and the first time
        after `give` every job it lists)."""
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
        self.summarize.load_kimi_linear_checkpoint = self._loader


# -- the window's jobs, for the check ----------------------------------------------------------


class JobCapture(closed_loop.Reservoir):
    """Wrappers on the model's prefill, decode step and routing and on the
    task's generation that keep, for a seeded reservoir of `keep` jobs, the
    prompt, the emitted ids, the logits at the last prompt position and at
    the decode steps `steps`, the experts each token was routed to in each
    expert layer, and the router inputs at `route_tokens` prompt positions
    spread evenly over the prompt. Those inputs are copied during the
    prefill into a staging buffer ([expert layers, route_tokens, d], made
    before the window), and into the job's reservoir slot if it is kept: a
    42k-token prompt's whole router inputs would be 5 GB. No
    synchronisation on the timed path."""

    def __init__(self, seed: int, keep: int, steps: list[int], route_tokens: int,
                 staging: torch.Tensor, slots: torch.Tensor):
        super().__init__(seed, keep)
        self.steps = set(steps)
        self.route_tokens = route_tokens
        self.staging, self.slots = staging, slots
        self.logits: dict[int, torch.Tensor] = {}
        self.routes: list[torch.Tensor] = []
        self.sample: torch.Tensor | None = None
        self.cache = None
        self.in_prefill = False
        self.step = 0
        self.jobs = 0
        self.starts: list[float] = []

    def install(self, spans: harness.Spans, summarize, kimi, llm) -> None:
        prefill_fn, step_fn, route_fn, gen_fn = (kimi.prefill, kimi.decode_step, llm.route,
                                                 summarize.generate)

        def prefill(model, ids, lengths, cache):
            self.in_prefill, self.cache = True, cache
            if self.on:
                n = int(ids.shape[0])
                self.sample = torch.linspace(0, n - 1, min(self.route_tokens, n),
                                             device=ids.device).round().long()
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
                m = len(self.sample)
                self.staging[len(self.routes), :m].copy_(x.index_select(0, self.sample))
                self.routes.append(chosen)
            return w, chosen

        def generate(model, prompts, *a, **kw):
            if self.on:
                self.starts.append(time.time())
            out = gen_fn(model, prompts, *a, **kw)
            if self.on:
                self.jobs += 1
                rec = {"prompt": prompts[0], "emitted": out[0], "row": 0, "offset": 0,
                       "logits": self.logits, "prefill_routes": self.routes,
                       "decode_routes": self.cache.routes.clone(), "sample": self.sample}
                self.offer(rec)
                j = next((i for i, k in enumerate(self.kept) if k is rec), None)
                if j is not None:
                    m = len(self.sample)
                    self.slots[j, :, :m].copy_(self.staging[:, :m])
                    rec["router_inputs"] = self.slots[j, :, :m]
            self.logits, self.routes = {}, []
            return out
        spans.patch(kimi, "prefill", prefill)
        spans.patch(kimi, "decode_step", step)
        spans.patch(llm, "route", route)
        spans.patch(summarize, "generate", generate)

    def describe(self) -> str:
        from eioku_tpu_torch.utils.metrics import METRICS

        tasks = [t for t in METRICS.recent_tasks() if t["type"] == "summarization"][-self.jobs:]
        spans = [[round(t["spans"].get(k, {}).get("total_ns", 0) / 1e6, 1)
                  for k in ("llm.prefill", "llm.decode")] for t in tasks]
        hit = sum(t["counters"].get("moe_experts_hit", 0) for t in tasks)
        chunks = sum(t["counters"].get("kda_chunks", 0) for t in tasks)
        line = (f"jobs: {self.seen} offered to the check, {len(self.kept)} kept; held experts "
                f"hit over the window's expert-layer calls {hit:.0f}; KDA chunks {chunks:.0f}; "
                f"ms of prefill and decode a job {spans}; each job's start, Unix s "
                f"{[round(t, 3) for t in self.starts]}")
        if self.slots.is_cuda:
            m = torch.cuda.memory_stats()
            line += (f"; the process's allocator: {m.get('num_alloc_retries', 0)} retries after "
                     f"freeing its cache, reserved peak "
                     f"{m.get('reserved_bytes.all.peak', 0) / 1e9:.2f} GB")
        return line


def install_capture(spans: harness.Spans, port: Port, seed: int, traffic: dict) -> JobCapture:
    from eioku_tpu_torch.models.llm import kimi_linear as kimi
    from eioku_tpu_torch.models.llm import model as llm

    keep, d, m = int(traffic["check_jobs"]), port.dims["hidden_size"], int(traffic["route_tokens"])
    layers = port.dims["num_hidden_layers"] - port.dims["first_k_dense_replace"]
    dtype = getattr(torch, port.job["compute_dtype"])
    staging = torch.empty(layers, m, d, dtype=dtype, device=port.device)
    slots = torch.empty(keep, layers, m, d, dtype=dtype, device=port.device)
    capture = JobCapture(seed, keep, list(traffic["check_steps"]), m, staging, slots)
    capture.install(spans, port.summarize, kimi, llm)
    return capture


# -- the check ------------------------------------------------------------------------------


def _follows(rec: dict, dims: dict):
    """The experts the port routed a kept job's tokens to, by layer: layer i
    -> [prompt + emitted - 1, k]."""
    first, steps = dims["first_k_dense_replace"], len(rec["emitted"]) - 1

    def layer(i: int) -> torch.Tensor:
        j = i - first
        return torch.cat([rec["prefill_routes"][j], rec["decode_routes"][j, 0, :steps]])
    return layer


def _forced(rec: dict, dims: dict):
    """The port's router inputs at the sampled prompt positions and the
    experts it chose from them, by layer."""
    first = dims["first_k_dense_replace"]

    def layer(i: int) -> tuple[torch.Tensor, torch.Tensor]:
        j = i - first
        return rec["router_inputs"][j], rec["prefill_routes"][j].index_select(0, rec["sample"])
    return layer


def check(kept: list[dict], model_cfg: dict, seed: int, device, control: bool = False) -> dict:
    """`chapters.readings` of the kept jobs against the float32 reference's
    full forward over prompt plus emitted tokens, on the seed's weights,
    the port's near-tie expert choices followed, and `route_gap` from the
    port's sampled router inputs routed again; with `control`, the
    reference in float8 as well, against a float32 reference that follows
    its choices and routes its router inputs again."""
    dims = dims_of(model_cfg)
    if not kept:
        return chapters.readings([], [])
    seqs = [rec["prompt"] + rec["emitted"][:-1] for rec in kept]
    positions = [list(range(len(rec["prompt"]) - 1, len(s))) for rec, s in zip(kept, seqs)]
    follows = [_follows(rec, dims) for rec in kept]
    forced = [_forced(rec, dims) for rec in kept]
    ref = ref_kimi.KimiLinear(dims, Arith(), lambda s, i: follows[s](i), AMBIGUITY,
                              lambda s, i: forced[s](i))
    models = [ref]
    if control:
        ctl = ref_kimi.KimiLinear(dims, Arith("fp8"), keep_inputs=True)
        sample = [rec["sample"].to(device) for rec in kept]
        models += [ctl, ref_kimi.KimiLinear(
            dims, Arith(), lambda s, i: ctl.chosen[(s, i)], AMBIGUITY,
            lambda s, i: (ctl.inputs.pop((s, i))[sample[s]], ctl.chosen[(s, i)][sample[s]]))]
    out = ref_kimi.logits(dims, lambda part: part_weights(dims, seed, part, device), seqs,
                          positions, models, device)
    r = chapters.readings(kept, out[0], *(out[1:] if control else ()))
    r.update(route_gap=ref.forced_gap, routed_again=ref.forced_tokens, route_drift=ref.drift,
             routes_followed=ref.followed)
    if control:
        r["control"].update(route_gap=models[2].forced_gap, route_drift=models[2].drift)
    return r


# -- operations from shapes -------------------------------------------------------------------


def _kda_sizes(dims: dict) -> tuple[int, int, int, int]:
    la = dims["linear_attn_config"]
    return la["num_heads"], la["head_dim"], la["num_heads"] * la["head_dim"], \
        la["short_conv_kernel_size"]


def kda_chunk_flops(dims: dict, chunk: int = 64, sub: int = 16) -> float:
    """The products of the chunked KDA prefill (`kimi_linear.py`
    `_kda_chunks`) for one chunk of every head, multiply-adds times two:
    the two decayed score matrices (rows of sub-block i against columns up
    to its end), the unit triangular solve for W and U, Kd^T W and Kd^T U,
    the chunk-to-chunk state update P S, and the outputs (M W, then its
    product with S, and M U)."""
    h, r, _, _ = _kda_sizes(dims)
    n = chunk // sub
    scores = 2 * (2 * sub * sub * r * n * (n + 1) // 2)
    solve = 2 * chunk * (chunk - 1) // 2 * 2 * r
    state = 2 * 2 * r * r * chunk + 2 * r * r * r
    outputs = 2 * chunk * chunk * r + 2 * chunk * r * r + 2 * chunk * chunk * r
    return h * (scores + solve + state + outputs)


def token_flops(dims: dict, keys: int, logits: bool, decode: bool = False) -> float:
    """The published math of one token through the model: KDA layers' q, k,
    v, f, g, beta and output projections and short convs (and, decoding,
    the recurrence's three products a head), MLA layers attending over
    `keys` positions (their own included; as `chapters.token_flops`), the
    dense MLP or the router, this card's share of the top-k experts
    (k x held / router) and the shared expert, and `lm_head` if its logits
    are used."""
    d, h = dims["hidden_size"], dims["num_attention_heads"]
    nope, rope, vd, lora = (dims["qk_nope_head_dim"], dims["qk_rope_head_dim"],
                            dims["v_head_dim"], dims["kv_lora_rank"])
    hk, r, w, taps = _kda_sizes(dims)
    kinds = ref_kimi.kinds(dims)
    kda = 2 * d * (3 * w + 2 * r + hk) + 2 * 2 * r * w + 2 * w * d + 2 * 3 * w * taps \
        + (2 * 3 * r * r * hk if decode else 0)
    mla = 2 * d * (h * (nope + rope) + lora + rope) + 2 * lora * h * (nope + vd) \
        + 2 * h * vd * d + 2 * h * (nope + rope + vd) * keys
    m = dims["moe_intermediate_size"]
    router = dims.get("num_router_experts") or dims["num_experts"]
    share = dims["num_experts_per_token"] * dims["num_experts"] / router
    sparse = 2 * d * router + 2 * 3 * d * m * (share + dims["num_shared_experts"])
    n_dense = dims["first_k_dense_replace"]
    return kinds.count("kda") * kda + kinds.count("mla") * mla \
        + n_dense * 2 * 3 * d * dims["intermediate_size"] + (len(kinds) - n_dense) * sparse \
        + (2 * d * dims["vocab_size"] if logits else 0)


def prefill_flops(dims: dict, length: int) -> float:
    """A prompt of `length` tokens: every token's projections, MLA's causal
    attention (token i over i + 1 positions), KDA's chunks (the prompt
    padded to whole chunks), logits at the last position."""
    kinds = ref_kimi.kinds(dims)
    attn = 2 * dims["num_attention_heads"] * (dims["qk_nope_head_dim"] + dims["qk_rope_head_dim"]
                                              + dims["v_head_dim"])
    return token_flops(dims, 0, False) * length \
        + kinds.count("mla") * attn * length * (length + 1) / 2 \
        + kinds.count("kda") * -(-length // 64) * kda_chunk_flops(dims) \
        + 2 * dims["hidden_size"] * dims["vocab_size"]


# -- the traced run ------------------------------------------------------------------------


_TRACE: dict = {}  # the traced run's state, read by layer_readings


def _device_s(events, name: str) -> float:
    """The device time of the kernels launched under the host ranges named
    `name`, in seconds."""
    cpu = torch.autograd.DeviceType.CPU
    total = 0.0
    for e in events:
        if e.name == name and e.device_type == cpu:
            total += getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
    return total / 1e6


ANNOTATIONS = ("llm.kda", "llm.mla")  # the program's profiler ranges


def _kernel_busy_s(events) -> float:
    """The union of the device's kernel intervals, in seconds: the
    profiler mirrors each host range onto the device's timeline, and those
    mirrors (the program's `llm.kda` and `llm.mla`, the benchmark's spans)
    span the gaps between their kernels, so they are left out."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.device_type == cuda and e.name not in ANNOTATIONS
             and not e.name.startswith("bench:")]
    return sum(b - a for a, b in harness._union(spans)) / 1e6


def trace_wrappers(spans: harness.Spans, traffic: dict, model_cfg: dict) -> dict:
    """The traced run's wrappers, as `chapters.trace_wrappers` sets them for
    Moonlight: a synchronised span of each job's generation, the useful
    operations (`useful_flops`), the profiler's slice (the next prefill and
    its first `profile_decode_steps` decode steps), the expert GEMMs' bound
    over the slice, the device time of the slice's prefill and of the
    kernels launched under its `llm.kda` ranges (`kda_prefill_pct`), and the
    slice's kernel time without the ranges' mirrors
    (`device_idle_pct.wholechapters`)."""
    from torch.profiler import ProfilerActivity, profile

    from eioku_tpu_torch.ml import summarize
    from eioku_tpu_torch.models.llm import kimi_linear as kimi
    from eioku_tpu_torch.models.llm import model as llm

    dims = dims_of(model_cfg)
    held = range(dims.get("first_held_expert", 0),
                 dims.get("first_held_expert", 0) + dims["num_experts"])
    profile_steps = int(traffic["profile_decode_steps"])
    st = {"armed": False, "prof": None, "done": None, "steps": 0, "t0": 0.0, "slice_s": 0.0,
          "lengths": [], "step": 0, "in_prefill": False, "moe_bound_s": 0.0, "moe_calls": 0,
          "ends": [], "kda_device_s": None, "prefill_device_s": None, "kernel_busy_s": None,
          "what": f"one job's prefill and its first {profile_steps} decode steps"}
    _TRACE.clear()
    _TRACE.update(st=st)
    c = spans.counters
    spans.wrap(summarize, "generate", "generate")
    prefill_fn, step_fn, experts_fn = kimi.prefill, kimi.decode_step, llm.routed_experts

    def prefill(model, ids, lengths, cache):
        if st["armed"]:
            torch.cuda.synchronize()
            st.update(prof=profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]),
                      armed=False, steps=0)
            t = time.perf_counter()
            st["prof"].start()
            st["t0"] = time.perf_counter()
            harness.log(f"profiler started in {st['t0'] - t:.3f} s")
        st["lengths"], st["step"], st["in_prefill"] = list(lengths), 0, True
        c["useful_flops"] += sum(prefill_flops(dims, n) for n in lengths)
        try:
            if st["prof"] is None:
                return prefill_fn(model, ids, lengths, cache)
            with torch.profiler.record_function("bench:prefill"):
                return prefill_fn(model, ids, lengths, cache)
        finally:
            st["in_prefill"] = False

    def step(model, tokens, pos, cache):
        st["step"] += 1
        c["useful_flops"] += sum(token_flops(dims, n + st["step"], True, decode=True)
                                 for n in st["lengths"])
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
            events = st["done"].events()
            st["kda_device_s"] = _device_s(events, "llm.kda")
            st["prefill_device_s"] = _device_s(events, "bench:prefill")
            st["kernel_busy_s"] = _kernel_busy_s(events)
            calls, st["ends"] = st["ends"], []
            for ends in calls:  # one prefill expert-layer call's group ends
                e = ends.tolist()
                hit = sum(b > a for a, b in zip([0] + e[:-1], e))
                st["moe_bound_s"] += chapters.expert_bound_s(dims, e[-1], hit)
                st["moe_calls"] += 1
            for layer in cache.routes[:, :, :profile_steps].transpose(1, 2).tolist():
                for rows in layer:  # one decode step of one expert layer: its held pairs
                    slots = [e for row in rows for e in row if e in held]
                    st["moe_bound_s"] += chapters.expert_bound_s(dims, len(slots), len(set(slots)))
                    st["moe_calls"] += 1
        return out

    def experts(x, gate_up, down, ends):
        if st["prof"] is not None and st["in_prefill"]:
            st["ends"].append(ends)
        return experts_fn(x, gate_up, down, ends)
    spans.patch(kimi, "prefill", prefill)
    spans.patch(kimi, "decode_step", step)
    spans.patch(llm, "routed_experts", experts)
    return st


# -- one run --------------------------------------------------------------------------------


def layer_readings(model_cfg: dict, done: list[tuple[float, float]]) -> dict:
    st = _TRACE.get("st") or {}
    return {"audio_s": sum(a for a, _ in done), "dims": dims_of(model_cfg),
            "moe_bound_s": st.get("moe_bound_s", 0.0), "moe_calls": st.get("moe_calls", 0),
            "kda_device_s": st.get("kda_device_s"), "prefill_device_s": st.get("prefill_device_s"),
            "kernel_busy_s": st.get("kernel_busy_s")}


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        rehearse: bool) -> tuple[dict, dict]:
    """One run of a whole-chapters cell: (result, checks)."""
    return closed_loop.run(sys.modules[__name__], cell, seed, seconds, trace, rehearse)


def calibrate(cell: harness.Cell, seeds: list[int], seconds: float) -> list[dict]:
    """The program's readings and the control's on each seed, with one
    set-up (`closed_loop.calibrate`)."""
    return closed_loop.calibrate(sys.modules[__name__], cell, seeds, seconds)
