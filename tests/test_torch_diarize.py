"""The port's speaker diarization (models/speaker, ml/diarize.py) against the
JAX package's, on the CPU at fp32.

Weights: the JAX package's `init_ecapa_params` at a small config (SMALL),
carried across with `from_jax_params`, or written in speechbrain's names as
`ecapa_voxceleb.ckpt` for both packages' loaders. Tolerances: fbanks within
1e-5 of their largest |value| (fp32 DFT matmuls summed in other orders; the
log turns a small mel energy's relative error into an absolute one, 3e-5 on
values up to ~7 seen), embeddings within 1e-5 (unit vectors); host stages,
labels and turns equal.

Random ECAPA weights embed every window nearly alike, and average linkage
then puts a merge wherever the threshold falls (ROADMAP Queue 3 hazard t).
The end-to-end test sets `distance_threshold` inside the widest gap of the
merge heights and asserts that every height of both packages keeps more
than LINK_MARGIN from it before it compares rows.
"""
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy.cluster.hierarchy import linkage

from eioku_tpu.ml import diarize as jax_diarize
from eioku_tpu.models.speaker import model as jax_ecapa
from eioku_tpu_torch.ml import diarize
from eioku_tpu_torch.ml.engine import InferenceEngine
from eioku_tpu_torch.models.speaker import model as ecapa
from test_torch_ocr import single_torch_thread

SR = 16000
SMALL = dict(channels=32, res2net_scale=4, se_channels=8, attention_channels=8,
             mfa_channels=48, embed_dim=16, compute_dtype="float32")
LINK_MARGIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread: under the suite's parallel workers the
    per-step parallel regions of small ops (decode steps, the LSTM) wait on
    descheduled threads."""
    with single_torch_thread():
        yield


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _voice(f0, seconds=1.5, amp=0.3, seed=0):
    """A speech-like signal: three harmonics of a gliding f0 under a 3 Hz
    syllabic envelope, with a little noise. A stationary tone would not do:
    its frames barely vary, and the pooled std's E[x^2] - mu^2 then cancels
    to fp32 noise in both packages (hazard t)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.05 * np.sin(2 * np.pi * 0.7 * t))) / SR
    x = sum(np.sin((h + 1) * phase) / (h + 1) for h in range(3)) \
        * (0.55 + 0.45 * np.sin(2 * np.pi * 3 * t))
    return (amp * x + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def small():
    """(JAX params, JAX config, port model) of one seeded small tree."""
    cfg = jax_ecapa.EcapaConfig(**SMALL)
    params = jax_ecapa.init_ecapa_params(cfg, seed=0)
    port = ecapa.ecapa_from_state_dict(ecapa.from_jax_params(_np(params)),
                                       ecapa.EcapaConfig(**SMALL))
    return params, cfg, port


def test_fbank_matches_jax():
    audio = (np.random.default_rng(0).standard_normal((2, 24000)) * 0.3).astype(np.float32)
    want = np.asarray(jax_ecapa.fbank(jnp.asarray(audio), 80))
    got = ecapa.fbank(torch.from_numpy(audio), 80).numpy()
    assert got.shape == want.shape == (2, 1 + (24000 - 400) // 160, 80)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("seconds", [1.5, 2.0])
def test_ecapa_matches_jax(small, seconds):
    params, cfg, port = small
    rng = np.random.default_rng(1)
    audio = np.stack([_voice(180, seconds), _voice(900, seconds, seed=1),
                      (rng.standard_normal(int(SR * seconds)) * 0.2).astype(np.float32)])
    want = np.asarray(jax_ecapa.ecapa_embed(params, jnp.asarray(audio), cfg))
    got = ecapa.ecapa_embed(port, torch.from_numpy(audio)).numpy()
    assert got.shape == (3, 16)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_speechbrain_names_and_from_jax_params_agree(small, tmp_path):
    """The port's state dict is in speechbrain's names: the JAX package's
    speechbrain converter reads it back to the tree the port was made from,
    and both loaders read it as a checkpoint."""
    params, cfg, port = small
    sd = port.state_dict()
    back = jax_ecapa.convert_speechbrain_state_dict(sd, cfg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    torch.save(sd, tmp_path / "ecapa_voxceleb.ckpt")
    loaded = ecapa.load_ecapa(str(tmp_path), ecapa.EcapaConfig(**SMALL))
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    jax_loaded = jax_ecapa.load_ecapa(str(tmp_path), cfg)
    for a, b in zip(jax.tree.leaves(jax_loaded), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # without a checkpoint: random init from the seed, at the config's widths
    fresh = ecapa.load_ecapa(None, ecapa.EcapaConfig(**SMALL))
    assert fresh.blocks[0].conv.conv.weight.shape == (32, 80, 5)


def test_host_stages_match_jax():
    rng = np.random.default_rng(2)
    audio = np.concatenate([_voice(200, 4.0), np.zeros(SR * 2, np.float32),
                            _voice(700, 3.0)])
    for vad in (True, False):
        got = diarize.slice_windows(audio, vad=vad)
        want = jax_diarize.slice_windows(audio, vad=vad)
        assert [s for s, _ in got] == [s for s, _ in want]
    assert [s for s, _ in diarize.slice_windows(audio[:SR])] == \
        [s for s, _ in jax_diarize.slice_windows(audio[:SR])] == [0]
    # two well-separated directions plus noise
    centers = rng.standard_normal((2, 16))
    embs = np.concatenate([centers[i] + 0.1 * rng.standard_normal((5, 16))
                           for i in (0, 1, 0)]).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=-1, keepdims=True)
    for kw in ({}, {"max_speakers": 1}, {"distance_threshold": 0.01}):
        np.testing.assert_array_equal(diarize.cluster_embeddings(embs, **kw),
                                      jax_diarize.cluster_embeddings(embs, **kw))
    labels = diarize.cluster_embeddings(embs)
    windows = [(i * 750, None) for i in range(len(embs))]
    windows[10] = (12000, None)  # a gap splits a turn
    for kw in ({}, {"max_gap_ms": 0, "duration_ms": 9000}):
        assert diarize.windows_to_turns(windows, labels, embs, **kw) == \
            jax_diarize.windows_to_turns(windows, labels, embs, **kw)
    assert diarize.cluster_embeddings(embs[:1]).tolist() == [0]
    assert diarize.windows_to_turns([], np.zeros(0), embs[:0]) == []


def _write_wav(path, audio):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype(np.int16).tobytes())


@pytest.fixture(scope="module")
def talk(tmp_path_factory, small):
    """A two-"speaker" wav (a low and a high harmonic voice taking turns,
    with pauses) beside a stub video, and the small tree as the checkpoint."""
    d = tmp_path_factory.mktemp("torch_diarize")
    parts = []
    for _ in range(2):
        parts += [_voice(140, 4.0), np.zeros(SR // 2, np.float32),
                  _voice(1100, 3.0, amp=0.2, seed=1), np.zeros(SR, np.float32)]
    _write_wav(d / "talk.wav", np.concatenate(parts))
    (d / "talk.mp4").write_bytes(b"stub")
    torch.save(small[2].state_dict(), d / "ecapa_voxceleb.ckpt")
    return d


def _threshold(*embs: np.ndarray) -> float:
    """The middle of the widest gap between merge heights, after asserting
    that both packages' heights keep LINK_MARGIN from it."""
    heights = [np.sort(linkage(e, method="average", metric="cosine")[:, 2]) for e in embs]
    h = heights[0]
    k = int(np.argmax(np.diff(h)))
    thr = float((h[k] + h[k + 1]) / 2)
    for hs in heights:
        assert np.abs(hs - thr).min() > LINK_MARGIN, (hs, thr)
    return thr


def test_run_diarization_rows_equal_jax(talk, small):
    params, cfg, _ = small
    wav = str(talk / "talk.wav")
    windows = diarize.slice_windows(diarize.audio_io.load_audio(wav))
    embs = diarize.embed_windows(diarize._load_model(str(talk), ecapa.EcapaConfig(**SMALL),
                                                     torch.device("cpu")), windows)
    jax_embs = jax_diarize.embed_windows(params, windows, cfg)
    np.testing.assert_allclose(embs, jax_embs, rtol=0, atol=1e-5)
    config = {**SMALL, "distance_threshold": _threshold(embs, jax_embs)}
    want = jax_diarize.run_diarization(str(talk / "talk.mp4"), config,
                                       model_cache_dir=str(talk))
    got = InferenceEngine(model_cache_dir=str(talk), device="cpu").run_task(
        "speaker_diarization", str(talk / "talk.mp4"), config)
    assert len({r["payload"]["label"] for r in want}) >= 2
    assert got == want


def test_diarization_defaults_to_fp32_on_the_cpu(talk, monkeypatch):
    seen = []
    real = diarize._load_model

    def spy(cache, cfg, device):
        seen.append(cfg.compute_dtype)
        return real(cache, cfg, device)
    monkeypatch.setattr(diarize, "_load_model", spy)
    cfg = {k: v for k, v in SMALL.items() if k != "compute_dtype"}
    rows = diarize.run_diarization(str(talk / "talk.wav"), cfg,
                                   model_cache_dir=str(talk), device="cpu")
    assert rows and seen == ["float32"]
    assert diarize.run_diarization(str(talk / "none.mp4"), cfg, device="cpu") == []


def test_diarization_needs_a_device_on_a_cpu_host(talk, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        diarize.run_diarization(str(talk / "talk.wav"), SMALL)


def test_turns_reach_jump_by_speaker(talk, tmp_path):
    """The engine's turns, written as speaker.turn artifacts through the
    port's repositories, are what jump-by-speaker walks."""
    from eioku_tpu_torch.db.connection import Database
    from eioku_tpu_torch.db.migrations import run_migrations
    from eioku_tpu_torch.domain.artifacts import ArtifactEnvelope, new_id
    from eioku_tpu_torch.domain.schema_registry import SchemaRegistry, register_all_schemas
    from eioku_tpu_torch.repositories import ArtifactRepository
    from eioku_tpu_torch.repositories.selection_policy_manager import SelectionPolicyManager
    from eioku_tpu_torch.services.jump_service import JumpNavigationService

    register_all_schemas()
    engine = InferenceEngine(model_cache_dir=str(talk), device="cpu")
    windows = diarize.slice_windows(diarize.audio_io.load_audio(str(talk / "talk.wav")))
    embs = diarize.embed_windows(diarize._load_model(
        str(talk), ecapa.EcapaConfig(**SMALL), torch.device("cpu")), windows)
    rows = engine.run_task("speaker_diarization", str(talk / "talk.wav"),
                           {**SMALL, "distance_threshold": _threshold(embs)})
    for r in rows:
        SchemaRegistry.validate("speaker.turn", 1, r["payload"])
    first = rows[0]["payload"]
    later = [r for r in rows[1:] if r["payload"]["label"] == first["label"]]
    other = [r for r in rows if r["payload"]["label"] != first["label"]]
    assert later and other
    db = Database(f"sqlite:///{tmp_path}/jump.db")
    try:
        run_migrations(db)
        arts = ArtifactRepository(db)
        arts.batch_create([ArtifactEnvelope(
            artifact_id=new_id(), asset_id="v1", artifact_type="speaker.turn",
            schema_version=1, span_start_ms=r["span_start_ms"],
            span_end_ms=r["span_end_ms"], payload_json=r["payload"], producer="p",
            producer_version="1", model_profile="balanced", config_hash="c",
            input_hash="i", run_id="r1") for r in rows])
        jump = JumpNavigationService(arts, SelectionPolicyManager(db))
        hit = jump.jump("v1", "speaker", from_ms=first["start_ms"] + 1,
                        direction="next", label=first["label"])
        assert hit["start_ms"] == later[0]["span_start_ms"]
        hit = jump.jump("v1", "speaker", from_ms=rows[-1]["span_end_ms"] + 1,
                        direction="prev", label=other[-1]["payload"]["label"])
        assert hit["start_ms"] == other[-1]["span_start_ms"]
    finally:
        db.close()


def test_worker_completes_a_diarization_job(talk, tmp_path):
    """A speaker_diarization job (discovery creates none) through the port's
    queue and worker: the task completes and its speaker.turn artifacts are
    the engine's rows."""
    import asyncio
    import json
    import uuid

    from eioku_tpu_torch.api.app import build_context
    from eioku_tpu_torch.config.settings import AppConfig
    from eioku_tpu_torch.db.connection import Database
    from eioku_tpu_torch.domain.models import TaskStatus, Video
    from eioku_tpu_torch.queue.worker import WorkerSettings
    from eioku_tpu_torch.workers.main import build_worker

    wav = str(talk / "talk.wav")
    ctx = build_context(AppConfig(scan_paths=[], semantic_search=False, visual_search=False,
                                  model_cache_dir=str(talk)),
                        db=Database(f"sqlite:///{tmp_path}/w.db"))
    video = Video(path=wav)
    ctx.videos.save(video)
    task_id = str(uuid.uuid4())
    ctx.producer.enqueue_task(task_id, "speaker_diarization", video.id, wav, SMALL)
    engine = InferenceEngine(model_cache_dir=str(talk), device="cpu")
    worker = build_worker(app_ctx=ctx, engine=engine,
                          settings=WorkerSettings(max_jobs=1, poll_delay_s=0.01))
    asyncio.run(worker.drain())
    assert ctx.tasks.get(task_id).status is TaskStatus.COMPLETED
    want = engine.run_task("speaker_diarization", wav, SMALL)
    got = [(r[0], r[1], json.loads(r[2])) for r in ctx.db.query(
        "SELECT span_start_ms, span_end_ms, payload_json FROM artifacts "
        "WHERE artifact_type = 'speaker.turn' ORDER BY rowid")]
    assert got == [(r["span_start_ms"], r["span_end_ms"], r["payload"]) for r in want]
    assert got
