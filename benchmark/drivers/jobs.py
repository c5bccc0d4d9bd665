"""Closed-loop transcription jobs on one worker: the traffic's audio files,
one `InferenceEngine.run_task("transcription", ...)` after another, as the
port's worker runs them. This module is Whisper's part of the closed loop
(`closed_loop.py` runs it; its interface is described there).

Set-up makes the seeded weights on the card and hands them to the port's
own loader (`load_state_dict` into its `Whisper`, then `_load_model`'s cast
and cache) in place of a checkpoint file's bytes, writes the seeded
speech-like audio, and runs one warm-up job that takes every shape the
window takes. The window runs whole passes over the traffic's jobs in its
order and closes at the end of the first pass that ends after `--seconds`,
so that every run does the same work; the rate is all the audio of the
completed jobs over the true elapsed time.

`correct` compares what the window's own batches produced, on batches drawn
by a seeded reservoir: the log-mel front end, the encoder's states (K3 in
every layer) and each token the port emitted (through its cache) against
the reference's beam-width best at its position, the float32 reference run
on the same audio and tokens once the window has closed.
"""
from __future__ import annotations

import gc
import math
import os
import shutil
import sys
import time
import wave

import numpy as np

from benchmark import harness, roofline
from benchmark import weights as bench_weights
from benchmark.drivers import closed_loop
# the loop's own, re-exported: callers that drive this cell read them from here
from benchmark.drivers.closed_loop import settings as _settings  # noqa: F401
from benchmark.drivers.closed_loop import window  # noqa: F401
from benchmark.reference import whisper as ref_whisper
from benchmark.reference.precision import Arith

SR = 16000
RATE = "audio_s_per_s"
CHECKED = ("mel_err", "enc_err", "dec_gap")
COMPARED = "windows"


# -- traffic ------------------------------------------------------------------------


def speech_like(duration_s: float, rng: np.random.Generator, p: dict) -> np.ndarray:
    """Voiced segments (a pulse train at f0 through three formant
    resonators, under a syllable-rate envelope) between pauses, over noise
    `noise_db` below the speech's level; float32 at 16 kHz."""
    from scipy.signal import lfilter

    n = int(duration_s * SR)
    x = np.zeros(n, np.float64)
    t = int(rng.uniform(0.0, p["pause_s"][1]) * SR)
    while t < n:
        seg = min(int(rng.uniform(*p["segment_s"]) * SR), n - t)
        tt = np.arange(seg) / SR
        f0 = rng.uniform(*p["f0_hz"]) * (1 + 0.08 * np.sin(2 * np.pi * rng.uniform(0.2, 1.0) * tt))
        source = np.diff(np.floor(np.cumsum(f0 / SR)), prepend=0.0)
        syl_hz = rng.uniform(*p["syllable_hz"])
        env = 0.5 * (1 - np.cos(2 * np.pi * syl_hz * tt))
        voiced = np.zeros(seg)
        syl_n = max(int(SR / syl_hz), 1)
        for s0 in range(0, seg, syl_n):
            chunk = source[s0:s0 + syl_n]
            for lo, hi, bw in ((300, 900, 90), (900, 2500, 120), (2500, 3500, 200)):
                r = math.exp(-math.pi * bw / SR)
                a = [1.0, -2 * r * math.cos(2 * math.pi * rng.uniform(lo, hi) / SR), r * r]
                voiced[s0:s0 + len(chunk)] += lfilter([1 - r], a, chunk)
        x[t:t + seg] = voiced * env
        t += seg + int(rng.uniform(*p["pause_s"]) * SR)
    active = x[x != 0]
    x *= 0.1 / (float(np.sqrt(np.mean(active ** 2))) if active.size else 1.0)
    x += rng.standard_normal(n) * 0.1 * 10 ** (p["noise_db"] / 20)
    return np.clip(x, -1, 1).astype(np.float32)


def write_wav(path: str, x: np.ndarray) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())


def write_jobs(folder: str, seed: int, traffic: dict) -> tuple[str, list[tuple[str, float]]]:
    """The warm-up job and the window's jobs, as `<name>.mp4` paths whose
    audio is a `.wav` sidecar (there is no video file; the task reads the
    sidecar). Every seed gets the same durations in the same order: the
    seed changes the signal, not the work. Returns (warm-up path,
    [(path, audio seconds)])."""
    shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder)
    rng = np.random.default_rng([seed, 17])
    paths = []
    for i, dur in enumerate([traffic["warmup_s"]] + list(traffic["durations_s"])):
        base = os.path.join(folder, f"job{i:02d}")
        write_wav(base + ".wav", speech_like(dur, rng, traffic["speech"]))
        paths.append((base + ".mp4", float(dur)))
    return paths[0][0], paths[1:]


# -- the port ---------------------------------------------------------------------------


class Port:
    """The port's transcription entry, fed the benchmark's seeded weights."""

    def __init__(self, model_cfg: dict, device: str, cache: str):
        import torch

        from eioku_tpu_torch.ml import transcribe
        from eioku_tpu_torch.ml.engine import InferenceEngine
        from eioku_tpu_torch.models.whisper import weights as port_weights
        from eioku_tpu_torch.models.whisper.model import Whisper

        self.transcribe = transcribe
        self.dims = model_cfg["config"]
        self.job = dict(model_cfg["job"])
        self.device = device
        self.state: dict | None = None
        os.makedirs(cache, exist_ok=True)
        # with this file present the entry takes its checkpoint path; the
        # tensors come from `state`, not from the file (no 3 GB write a run)
        open(os.path.join(cache, f"whisper-{model_cfg['port_model']}.pt"), "wb").close()
        self._loader = transcribe.load_whisper_checkpoint

        def from_memory(path, cfg, dev):
            with torch.device("meta"):
                model = Whisper(cfg)
            return port_weights.load_state_dict(model.to_empty(device=dev), self.state)
        transcribe.load_whisper_checkpoint = from_memory
        self.engine = InferenceEngine(model_cache_dir=cache, device=device)

    def give(self, seed: int) -> None:
        """The seed's weights for the entry's next load (its cache cleared)."""
        self.forget()
        self.state = bench_weights.whisper_weights(self.dims, seed, self.device)

    def run(self, path: str):
        out = self.engine.run_task("transcription", path, self.job)
        self.state = None  # loaded: the port holds its own copy
        return out

    def forget(self) -> None:
        import torch

        self.transcribe._load_model.cache_clear()
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def close(self) -> None:
        self.forget()
        self.transcribe.load_whisper_checkpoint = self._loader


# -- the window's batches, for the check ------------------------------------------------------


class BatchCapture(closed_loop.Reservoir):
    """Wrappers on the transcription module's mel, encoder and decoder
    entries that keep, for a seeded reservoir of `keep` batches, the audio
    handed to the mel, the mel, the encoder's states and the decoded rows.
    They keep references only: no
    copy and no synchronisation on the timed path."""

    def __init__(self, seed: int, keep: int):
        super().__init__(seed, keep)
        self.last: dict = {}
        self.steps = 0  # decoder steps taken
        self.batches: list[tuple[int, float]] = []  # (decoder steps, host s) per decode

    def install(self, spans: harness.Spans, transcribe) -> None:
        from eioku_tpu_torch.models.whisper import decoding

        mel_fn, enc_fn, dec_fn = (transcribe.log_mel_spectrogram, transcribe.whisper_encode,
                                  transcribe.whisper_decode_windows)
        step_fn = decoding.decoder_step

        def step(*a):
            self.steps += 1
            return step_fn(*a)

        def mel(audio, *a, **kw):
            out = mel_fn(audio, *a, **kw)
            if self.on:
                self.last = {"audio": audio, "mel": out}
            return out

        def enc(model, m):
            out = enc_fn(model, m)
            if self.on and self.last.get("mel") is m:
                self.last["enc"] = out
            return out

        def dec(model, e, init, *a, **kw):
            t, n = time.perf_counter(), self.steps
            out = dec_fn(model, e, init, *a, **kw)
            if self.on:  # each step ends on a synchronisation: the wall is the device's too
                self.batches.append((self.steps - n, time.perf_counter() - t))
            if self.on and self.last.get("enc") is e:
                self.offer(dict(self.last, n_init=int(init.shape[1]), tokens=out[0],
                                timestamps=bool(kw.get("timestamps", True))))
                self.last = {}
            return out
        spans.patch(transcribe, "log_mel_spectrogram", mel)
        spans.patch(transcribe, "whisper_encode", enc)
        spans.patch(transcribe, "whisper_decode_windows", dec)
        spans.patch(decoding, "decoder_step", step)

    def describe(self) -> str:
        return (f"decodes: {len(self.batches)} batches; decoder steps "
                f"{[n for n, _ in self.batches]}; ms a step "
                f"{[round(w / max(n, 1) * 1e3, 2) for n, w in self.batches]}")


def install_capture(spans: harness.Spans, port: Port, seed: int, traffic: dict) -> BatchCapture:
    capture = BatchCapture(seed, int(traffic["check_batches"]))
    capture.install(spans, port.transcribe)
    return capture


# -- the check ------------------------------------------------------------------------------


def reference_from_seed(dims: dict, seed: int, device, quant: str | None = None):
    """The reference Whisper on the seed's weights (made as the port's were,
    then widened to float32)."""
    p = {k: v.float() for k, v in bench_weights.whisper_weights(dims, seed, device).items()}
    return ref_whisper.Whisper(p, dims["encoder_attention_heads"], Arith(quant))


AMBIGUITY = 0.25  # nats: a timestamp-forcing margin this close is rounding's to decide


def _gap(vecs: list, tok: int, k: int) -> float:
    """How far (nats) `tok` lies below the k-th best token, under the
    closer of the rules' decisions (0 when it is among the k best)."""
    import math

    best = math.inf
    for v in vecs:
        lp = float(v[tok])
        best = min(best, math.inf if lp == -math.inf else
                   max(0.0, float(v.topk(k).values[-1]) - lp))
    return best


def readings(kept: list[dict], ref, n_mels: int, sp, beam: int, control=None) -> dict:
    """The numbers `correct` compares, over the kept batches' real windows
    (rows whose audio is not all zeros): mel_err, the largest absolute
    log-mel difference; enc_err, the largest relative (Frobenius) distance
    of one window's encoder states; dec_gap, the widest gap (nats) by which
    an emitted token lies below the reference's `beam`-th best token at its
    position, the reference reading the row through the port's own prefix
    (a beam search keeps a token only if it is among its parent's `beam`
    best). With `control` (the reference in float8), the same numbers of
    the control put in the program's place under "control": its mel and
    encoder states, and at each position the worst of the `beam` tokens it
    ranks best."""
    out = {k: 0.0 for k in CHECKED} | {"windows": 0, "tokens": 0}
    ctl = {k: 0.0 for k in CHECKED}
    for rec in kept:
        audio = rec["audio"].float()
        real = (audio.abs().amax(dim=1) > 0).nonzero().squeeze(1).tolist()
        mel_ref = ref_whisper.log_mel(audio, n_mels)
        enc_ref = ref.encode(mel_ref)
        tokens = rec["tokens"].long()
        logits = ref.logits(tokens[real], enc_ref[real])
        rows = [tokens[i].tolist() for i in real]
        sides = [(out, rec["mel"].float(), rec["enc"].float(), None)]
        if control is not None:
            mel_c = ref_whisper.log_mel(audio, n_mels, control.a)
            enc_c = control.encode(mel_c)
            sides.append((ctl, mel_c, enc_c, control.logits(tokens[real], enc_c[real])))
        for r, mel, enc, logits_c in sides:
            r["mel_err"] = max(r["mel_err"], float((mel - mel_ref).abs().max()))
            for j, i in enumerate(real):
                dist = (enc[i] - enc_ref[i]).norm() / enc_ref[i].norm()
                r["enc_err"] = max(r["enc_err"], float(dist))
                steps = ref_whisper.ruled_distributions(
                    logits[j], rows[j], rec["n_init"], sp, rec["timestamps"], AMBIGUITY)
                if logits_c is None:
                    for tok, vecs in steps:
                        r["dec_gap"] = max(r["dec_gap"], _gap(vecs, tok, beam))
                        out["tokens"] += 1
                    continue
                mine = ref_whisper.ruled_distributions(
                    logits_c[j], rows[j], rec["n_init"], sp, rec["timestamps"])
                for (tok, vecs), (_, vcs) in zip(steps, mine):
                    picks = vcs[0].topk(beam).indices.tolist()
                    r["dec_gap"] = max(r["dec_gap"], max(_gap(vecs, c, beam) for c in picks))
        out["windows"] += len(real)
    if control is not None:
        out["control"] = ctl
    return out


# -- the traced run ------------------------------------------------------------------------


def trace_wrappers(spans: harness.Spans, traffic: dict, model_cfg: dict) -> dict:
    """The traced run's wrappers, around the capture's: synchronised spans of
    the audio front end, the mel, the encoder and the decoder; the decoder's
    step count and the useful operations from shapes (real windows and their
    beam rows); and the profiler's slice, armed by the returned state: it
    starts at the next batch's mel and stops after the traffic's
    `profile_decode_steps` decoder steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from eioku_tpu_torch.ml import audio_io, transcribe
    from eioku_tpu_torch.models.whisper import decoding

    dims, batch = model_cfg["config"], int(model_cfg["job"]["batch_size"])
    profile_steps = int(traffic["profile_decode_steps"])
    d, vocab = dims["d_model"], dims["vocab_size"]
    st = {"real": 0, "rows": 1, "in_decode": False, "armed": False, "prof": None,
          "done": None, "steps": 0, "t0": 0.0, "slice_s": 0.0,
          "what": f"one batch's mel and encoder, its first {profile_steps} decoder steps"}
    c = spans.counters
    for attr in ("find_audio_for_video", "load_audio", "split_windows"):
        spans.wrap(audio_io, attr, "audio_prep")

    def mel_meta(args, kwargs, out):
        st["rows"] = int(args[0].shape[0])
        st["real"] = int((args[0].abs().amax(dim=1) > 0).sum())
        c["encoded_rows"] += st["rows"]
        c["useful_flops"] += roofline.whisper_encoder_flops(
            st["real"], d, dims["encoder_layers"], dims["num_mel_bins"])
        return {}

    def dec_meta(args, kwargs, out):
        c["real_windows_decoded"] += st["real"]
        c["useful_flops"] += roofline.whisper_cross_kv_flops(st["real"], d, dims["decoder_layers"])
        return {}
    spans.wrap(transcribe, "log_mel_spectrogram", "mel", meta=mel_meta)
    spans.wrap(transcribe, "whisper_encode", "encode")
    spans.wrap(transcribe, "whisper_decode_windows", "decode", meta=dec_meta)

    mel_fn, dec_fn, step_fn = (transcribe.log_mel_spectrogram, transcribe.whisper_decode_windows,
                               decoding.decoder_step)

    def mel(audio, *a, **kw):
        if st["armed"] and audio.shape[0] == batch:
            torch.cuda.synchronize()
            st.update(prof=profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]),
                      armed=False, steps=0, t0=time.perf_counter())
            st["prof"].start()
        return mel_fn(audio, *a, **kw)

    def dec(*a, **kw):
        st["in_decode"] = True
        try:
            return dec_fn(*a, **kw)
        finally:
            st["in_decode"] = False

    def step(model, cross_k, cross_v, tokens, self_k, self_v, pos):
        if st["prof"] is None:
            out = step_fn(model, cross_k, cross_v, tokens, self_k, self_v, pos)
        else:  # a range that ends inside the slice, unlike the decode's own
            with torch.profiler.record_function("bench:decoder_step"):
                out = step_fn(model, cross_k, cross_v, tokens, self_k, self_v, pos)
        if st["in_decode"]:
            c["decode_steps"] += 1
            c["useful_flops"] += roofline.whisper_decode_step_flops(
                tokens.shape[0] * st["real"] / st["rows"], pos, d, dims["decoder_layers"], vocab)
            if st["prof"] is not None:
                st["steps"] += 1
                if st["steps"] >= profile_steps:
                    torch.cuda.synchronize()
                    st["slice_s"] = time.perf_counter() - st["t0"]
                    st["prof"].stop()
                    st["done"], st["prof"] = st["prof"], None
        return out
    spans.patch(transcribe, "log_mel_spectrogram", mel)
    spans.patch(transcribe, "whisper_decode_windows", dec)
    spans.patch(decoding, "decoder_step", step)
    return st


# -- one run --------------------------------------------------------------------------------


def _beam(model_cfg: dict) -> int:
    """The job's beam width: the entry's default of 5 unless the job sets it."""
    return int(model_cfg["job"].get("beam_size", 5))


def check(kept: list[dict], model_cfg: dict, seed: int, device, control: bool = False) -> dict:
    """`readings` of the kept batches against the float32 reference on the
    seed's weights (with `control`, the reference in float8 as well)."""
    dims = model_cfg["config"]
    ref = reference_from_seed(dims, seed, device)
    ctl = ref_whisper.Whisper(ref.p, dims["encoder_attention_heads"], Arith("fp8")) \
        if control else None
    return readings(kept, ref, dims["num_mel_bins"], ref_whisper.Specials(dims["vocab_size"]),
                    _beam(model_cfg), control=ctl)


def layer_readings(model_cfg: dict, done: list[tuple[float, float]]) -> dict:
    return {"audio_s": sum(a for a, _ in done), "dims": model_cfg["config"],
            "batch": int(model_cfg["job"]["batch_size"])}


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        rehearse: bool) -> tuple[dict, dict]:
    """One run of a transcription cell: (result, checks)."""
    return closed_loop.run(sys.modules[__name__], cell, seed, seconds, trace, rehearse)


def calibrate(cell: harness.Cell, seeds: list[int], seconds: float) -> list[dict]:
    """The program's readings and the control's (the reference in float8 in
    its place, on the same audio and tokens) on each seed, with one set-up:
    per seed the weights are made and loaded and the window runs `seconds`."""
    return closed_loop.calibrate(sys.modules[__name__], cell, seeds, seconds)
