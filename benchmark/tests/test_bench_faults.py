"""The check that decides `correct`, shown to fail: each cell's run at its
rehearsal size on the CPU (the harness's look for a card skipped) with the
timed path broken underneath, and the control (the reference in float8 in
the program's place) against the cell's limits.

A one-chip cell has no exchange between chips, so that fault is not
planted. A few minutes in all; the card itself is needed by none of these.
"""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.drivers import http_search, jobs
from benchmark.reference import whisper as ref_whisper
from benchmark.reference.precision import Arith

SPEC = harness.load_spec(f"{harness.BENCH_DIR}/pending/minilm.search.json")
SEED = 2_900_000_017


def _transcribe_faults():
    from eioku_tpu_torch.ml import transcribe
    from eioku_tpu_torch.models.whisper import decoding

    step, encode, decode = (decoding.decoder_step, transcribe.whisper_encode,
                            transcribe.whisper_decode_windows)

    def stale_state(model, cross_k, cross_v, tokens, self_k, self_v, pos):
        # the step's cache writes are lost: it returns its state unchanged
        return step(model, cross_k, cross_v, tokens, self_k.clone(), self_v.clone(), pos)

    def half_batch(model, mel):
        # half the batch encoded, the rest the mean of that half
        half = max(mel.shape[0] // 2, 1)
        enc = encode(model, mel[:half])
        return torch.cat([enc, enc.mean(0, keepdim=True).expand(mel.shape[0] - half, -1, -1)])

    def altered_token(model, enc, init, *a, **kw):
        tokens, avg_lp, no_speech = decode(model, enc, init, *a, **kw)
        tokens = tokens.clone()
        tokens[:, init.shape[1]] = 100  # a text token where a timestamp is due
        return tokens, avg_lp, no_speech
    return {"stale_state": (decoding, "decoder_step", stale_state),
            "half_batch": (transcribe, "whisper_encode", half_batch),
            "altered_token": (transcribe, "whisper_decode_windows", altered_token)}


def test_transcribe_rehearsal_is_correct_unbroken():
    cell = harness.Cell(SPEC, "large-v3.transcribe")
    result, checks = jobs.run(cell, SEED, 1.0, trace=False, rehearse=True)
    assert result["correct"], checks


@pytest.mark.parametrize("fault", ["stale_state", "half_batch", "altered_token"])
def test_transcribe_fault_is_not_correct(fault, monkeypatch):
    owner, attr, broken = _transcribe_faults()[fault]
    monkeypatch.setattr(owner, attr, broken)
    cell = harness.Cell(SPEC, "large-v3.transcribe")
    result, checks = jobs.run(cell, SEED, 1.0, trace=False, rehearse=True)
    assert not result["correct"], checks


def test_transcribe_control_is_not_correct():
    """The reference in float8 in the program's place, on a batch of the
    rehearsal's audio, fails one of the cell's limits."""
    cell = harness.Cell(SPEC, "large-v3.transcribe")
    model_cfg, traffic = jobs._settings(cell, rehearse=True)
    dims = model_cfg["config"]
    ref = jobs.reference_from_seed(dims, SEED, "cpu")
    control = ref_whisper.Whisper(ref.p, dims["encoder_attention_heads"], Arith("fp8"))
    rng = np.random.default_rng(3)
    audio = torch.from_numpy(jobs.speech_like(30.0, rng, traffic["speech"]))[None]
    mel = ref_whisper.log_mel(audio, dims["num_mel_bins"])
    enc = ref.encode(mel)
    sp = ref_whisper.Specials(dims["vocab_size"])
    row = [sp.sot, sp.sot + 1, sp.no_speech - 3, sp.ts_begin, 400, 50, sp.ts_begin + 20,
           sp.eot]  # start of transcript, English, transcribe; then <|0.00|> ...
    tokens = torch.tensor([row])
    kept = [{"audio": audio, "mel": mel, "enc": enc, "n_init": 3, "tokens": tokens,
             "timestamps": True}]
    r = jobs.readings(kept, ref, dims["num_mel_bins"], sp, 5, control=control)
    limits = cell.config["limits"]
    assert any(r["control"][k] > limits[k] for k in jobs.CHECKED), r["control"]


def test_search_rehearsal_is_correct_unbroken():
    cell = harness.Cell(SPEC, "minilm.search")
    result, checks = http_search.run(cell, SEED, 4.0, trace=False, rehearse=True)
    assert result["correct"] and result["failed"] == 0, checks


@pytest.mark.parametrize("fault", ["stale_state", "half_batch", "altered_answer"])
def test_search_fault_is_not_correct(fault):
    cell = harness.Cell(SPEC, "minilm.search")
    result, checks = http_search.run(cell, SEED, 4.0, trace=False, rehearse=True, fault=fault)
    assert not result["correct"], checks


def test_search_control_is_not_correct():
    cell = harness.Cell(SPEC, "minilm.search")
    lib_p, traffic = http_search._settings(cell, rehearse=True)
    lib = http_search.Library(f"{harness.CACHE_DIR}/minilm.search/library", SEED, lib_p)
    lib.build()
    ref, tok = http_search.reference_model(lib)
    control, _ = http_search.reference_model(lib, "fp8")
    queries = lib.queries(random.Random(SEED), 4, tuple(traffic["query_words"]))
    sample = [{"q": q, "body": {"results": []}} for q in queries]
    embeddings = {q: control.embed(tok.encode(q)).tolist() for q in queries}
    r = http_search.readings(sample, embeddings, lib, 0, ref, tok)
    limits = cell.config["limits"]
    assert any(r[k] > limits[k] for k in ("embed_err", "score_err")), r
