"""The plain references against the port's CPU path, on the benchmark's
seeded weights at small sizes (float32 on both sides). The test imports
both; the references import nothing of the port."""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.drivers import http_search, jobs
from benchmark.reference import whisper as ref_whisper

TINY = {"d_model": 384, "encoder_layers": 4, "decoder_layers": 4,
        "encoder_attention_heads": 6, "num_mel_bins": 80, "vocab_size": 51865}


@pytest.fixture(scope="module")
def tiny():
    """The port's tiny Whisper and the reference on one seed's weights."""
    from eioku_tpu_torch.models.whisper import weights as port_weights
    from eioku_tpu_torch.models.whisper.model import Whisper, WhisperConfig

    torch.set_num_threads(1)
    sd = weights.whisper_weights(TINY, 11, "cpu", torch.float32)
    port = port_weights.load_state_dict(Whisper(WhisperConfig("tiny", "float32")), sd).eval()
    ref = ref_whisper.Whisper(dict(sd), 6)
    audio = torch.from_numpy(np.stack([
        jobs.speech_like(30.0, np.random.default_rng(1), {
            "f0_hz": [90, 250], "syllable_hz": [4, 5], "segment_s": [1.0, 6.0],
            "pause_s": [0.2, 1.5], "noise_db": -30}),
        np.zeros(480000, np.float32)]))
    return port, ref, audio


def test_specials_match_the_port(tiny):
    from eioku_tpu_torch.models.whisper.tokenizer import WhisperTokens

    for vocab in (51865, 51866):
        sp, tk = ref_whisper.Specials(vocab), WhisperTokens(vocab)
        assert (sp.eot, sp.sot, sp.no_speech, sp.no_timestamps, sp.ts_begin) == \
            (tk.eot, tk.sot, tk.no_speech, tk.no_timestamps, tk.timestamp_begin)


def test_mel_and_encoder_match_the_port(tiny):
    from eioku_tpu_torch.models.whisper.mel import log_mel_spectrogram
    from eioku_tpu_torch.models.whisper.model import whisper_encode

    port, ref, audio = tiny
    mel_port = log_mel_spectrogram(audio, n_mels=80)
    mel_ref = ref_whisper.log_mel(audio, 80)
    assert float((mel_port - mel_ref).abs().max()) < 1e-4
    enc_port = whisper_encode(port, mel_ref)
    enc_ref = ref.encode(mel_ref)
    # the port's tanh GELU against the published exact one: ~1e-3 of the scale
    rel = float((enc_port - enc_ref).norm() / enc_ref.norm())
    assert rel < 5e-3


def test_decoder_rules_give_the_ports_beam_scores(tiny):
    """The port's beam-5 decode with timestamps: the reference's ruled
    log-probabilities along each emitted row average to the port's score."""
    from eioku_tpu_torch.models.whisper.decoding import (
        build_suppress_masks,
        whisper_decode_windows,
    )
    from eioku_tpu_torch.models.whisper.model import whisper_encode
    from eioku_tpu_torch.models.whisper.tokenizer import WhisperTokens

    port, ref, audio = tiny
    tk = WhisperTokens(51865)
    mel = ref_whisper.log_mel(audio, 80)
    enc = whisper_encode(port, mel)
    init = torch.tensor([tk.sot_sequence("en", timestamps=True)] * 2)
    always, begin = build_suppress_masks(tk, timestamps=True)
    out, avg_lp, _ = whisper_decode_windows(port, enc, init, always, begin, max_len=24,
                                            beam_size=5, timestamps=True)
    sp = ref_whisper.Specials(51865)
    logits = ref.logits(out, ref.encode(mel))
    for row in range(2):
        lps = ref_whisper.ruled_logprobs(logits[row], out[row].tolist(), 3, sp, True)
        assert sum(lps) / len(lps) == pytest.approx(float(avg_lp[row]), abs=2e-3)


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    p = {"chunks": 64, "chunks_per_video": 8, "words": 300, "zipf_s": 1.07, "sentences": 40,
         "sentence_words": [8, 16], "sentences_per_chunk": 5, "topics": 4, "topic_spread": 0.6,
         "vocab_size": 30522,
         "model": {"hidden_size": 384, "num_hidden_layers": 2, "num_attention_heads": 12,
                   "intermediate_size": 1536, "vocab_size": 30522,
                   "max_position_embeddings": 512}}
    lib = http_search.Library(str(tmp_path_factory.mktemp("lib")), 5, p)
    lib.build()
    return lib


def test_wordpiece_and_minilm_match_the_port(library):
    from eioku_tpu_torch.models.embed.minilm import MiniLMConfig, load_minilm, minilm_embed
    from eioku_tpu_torch.models.embed.tokenizer import WordPieceTokenizer

    torch.set_num_threads(1)
    cfg = MiniLMConfig(n_layers=2)
    port, _, pretrained = load_minilm(library.model_dir, cfg)
    assert pretrained
    port_tok = WordPieceTokenizer.from_cache_dir(library.model_dir, max_len=256)
    ref, tok = http_search.reference_model(library)
    texts = library.queries(random.Random(3), 4, (2, 12)) + [library.text(7)]
    for text in texts + ["Punctuation, digits 42 and UNSEEN-words!"]:
        ids, mask = port_tok.encode(text)
        assert tok.encode(text) == ids[:sum(mask)]
    ids, mask = port_tok.encode_batch(texts)
    got = minilm_embed(port, torch.from_numpy(ids), torch.from_numpy(mask))
    for i, text in enumerate(texts):
        want = ref.embed(tok.encode(text))
        assert float((got[i] - want).abs().max()) < 1e-5

