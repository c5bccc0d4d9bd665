"""The PyTorch port's remaining services and ops CLI against the JAX
package's (CPU).

- `people`: the same persons from the same seeded ArcFace tracks.
- `to_vtt` / `to_srt`: byte-equal subtitle files.
- `dump`: a library exported by one package and imported by the other gives
  the rows the exporter's own import gives.
- `import_eioku`: a seeded reference database imports to equal rows.
- `export_clip` on its cv2 re-encode path: equal frame counts.
- The ops CLI: every command through both packages' `main()` on copies of
  one database gives equal stdout (search scores within the bf16 tolerance
  of tests/test_torch_api.py) and equal files; `finetune` gives the JAX
  package's stats on a small seeded MiniLM; without CUDA the port's CLI
  raises at start unless EIOKU_FORCE_CPU=1 or both search indexes are off.

Rows minted while a package works (ids, timestamps) are made comparable the
way tests/test_torch_api.py does: uuid4 draws seeded alike, timestamp
columns (`TIME_FIELDS`) left out.
"""
import contextlib
import gzip
import io
import json
import pathlib
import shutil
import sys

import cv2
import numpy as np
import pytest
import scipy.io.wavfile
import torch

import eioku_tpu.cli as jax_cli
import eioku_tpu.ml.audio_io as jax_audio_io
from eioku_tpu.services import dump as jax_dump
from eioku_tpu.services import import_eioku as jax_import_eioku
from eioku_tpu.services import people as jax_people
from eioku_tpu.services import subtitles as jax_subtitles
from eioku_tpu.services.clips import export_clip as jax_export_clip
import eioku_tpu_torch.cli as port_cli
import eioku_tpu_torch.ml.audio_io as port_audio_io
from eioku_tpu_torch.services import dump as port_dump
from eioku_tpu_torch.services import import_eioku as port_import_eioku
from eioku_tpu_torch.services import people as port_people
from eioku_tpu_torch.services import subtitles as port_subtitles
from eioku_tpu_torch.services.clips import export_clip as port_export_clip
from test_clip import TINY
from test_import_eioku import make_reference_db
from test_torch_api import JAX, PORT, SCORE_TOL, TIME_FIELDS, _seed, _tiny_clip, \
    _write_inputs, seeded_uuid4
from test_torch_visual import PORT_TINY

SERVICES = {"jax": (jax_people, jax_subtitles, jax_dump, jax_import_eioku),
            "port": (port_people, port_subtitles, port_dump, port_import_eioku)}
TABLES = ("path_configs", "videos", "tasks", "runs", "artifact_selections", "artifacts",
          "scene_ranges", "object_labels", "face_clusters", "video_locations")


def _rows(db, table: str) -> list[dict]:
    rows = [{k: r[k] for k in r.keys() if k not in TIME_FIELDS | {"added_at"}}
            for r in db.query(f"SELECT * FROM {table}")]
    return sorted(rows, key=lambda r: json.dumps(r, sort_keys=True, default=str))


def _all_rows(ctx) -> dict:
    out = {t: _rows(ctx.db, t) for t in TABLES}
    out["transcript_fts"] = sorted(tuple(r) for r in ctx.db.query(
        "SELECT f.text, m.asset_id, m.start_ms FROM transcript_fts f "
        "JOIN transcript_fts_meta m ON m.rowid = f.rowid"))
    out["jobs"] = sorted((j.function, j.args[1], j.args[2])
                         for j in ctx.producer.queue.list_jobs(limit=1000))
    return out


def _context(pkg, path: pathlib.Path):
    cfg = pkg.config_cls(scan_paths=[], auto_discover=False, semantic_search=False,
                         visual_search=False)
    return pkg.build_context(cfg, db=pkg.database_cls(f"sqlite:///{path}"))


def _unit(v):
    v = np.asarray(v, np.float32)
    return v / np.linalg.norm(v)


def _seed_library(pkg, ctx, media: pathlib.Path) -> None:
    """Videos, tasks, runs, a stored selection, a path and artifacts with
    projections (transcripts, scenes, faces with ArcFace-like embeddings of
    three identities over three videos)."""
    Video, Task, TaskStatus = pkg.models.Video, pkg.models.Task, pkg.models.TaskStatus
    env = pkg.artifacts.ArtifactEnvelope
    ctx.paths.save(pkg.models.PathConfig(path=str(media)))
    for i in range(3):
        ctx.videos.save(Video(id=f"v{i}", path=str(media / f"v{i}.mp4"),
                              file_hash=f"h{i}", duration_ms=60_000))
    task = Task(id="t0", video_id="v0", task_type="transcription")
    task.transition(TaskStatus.RUNNING)
    task.transition(TaskStatus.COMPLETED)
    ctx.tasks.save(task)
    ctx.tasks.save(Task(id="t1", video_id="v1", task_type="scene_detection"))
    ctx.runs.save(pkg.artifacts.Run(
        run_id="run-1", asset_id="v0", task_type="transcription", producer="p",
        producer_version="1", model_profile="balanced", config_hash="c", input_hash="i"))
    common = dict(schema_version=1, producer="p", producer_version="1",
                  model_profile="balanced", config_hash="c", input_hash="i")
    rows = [env(artifact_id=f"tr-{i}", asset_id="v0", artifact_type="transcript.segment",
                span_start_ms=i * 1000, span_end_ms=(i + 1) * 1000, run_id="run-1",
                payload_json={"text": f"zebra stampede {i}", "language": "en",
                              "start_ms": i * 1000, "end_ms": (i + 1) * 1000}, **common)
            for i in range(3)]
    rows += [env(artifact_id=f"sc-{i}", asset_id="v1", artifact_type="scene",
                 span_start_ms=i * 20_000, span_end_ms=(i + 1) * 20_000, run_id="run-2",
                 payload_json={"scene_index": i, "start_ms": i * 20_000,
                               "end_ms": (i + 1) * 20_000, "duration_ms": 20_000}, **common)
             for i in range(3)]
    rng = np.random.default_rng(0)
    identities = [_unit(rng.standard_normal(64)) for _ in range(3)]
    tracks = [("v0", "face_0", 0, 4), ("v0", "face_1", 1, 2), ("v1", "face_0", 0, 3),
              ("v1", "face_1", 2, 5), ("v2", "face_0", 1, 1), ("v2", "face_3", 2, 2)]
    for vid, cid, ident, n in tracks:
        for k in range(n):
            emb = _unit(identities[ident] + rng.normal(0, 0.05, 64))
            rows.append(env(
                artifact_id=f"face-{vid}-{cid}-{k}", asset_id=vid,
                artifact_type="face.detection", span_start_ms=k * 500,
                span_end_ms=k * 500 + 33, run_id=f"run-face-{vid}",
                payload_json={"cluster_id": cid, "confidence": 0.9, "frame_number": k,
                              "bounding_box": {"x": 1, "y": 1, "width": 9, "height": 9},
                              "embedding": [float(x) for x in emb]}, **common))
    ctx.artifacts.batch_create(rows)
    ctx.policies.set_policy("v0", "transcript.segment",
                            pkg.artifacts.SelectionPolicy(mode="pinned", run_id="run-1"))


# ---------------------------------------------------------------------------
# people, subtitles


@pytest.fixture(scope="module")
def libraries(tmp_path_factory):
    out = {}
    for pkg in (JAX, PORT):
        tmp = tmp_path_factory.mktemp(f"lib_{pkg.name}")
        ctx = _context(pkg, tmp / "lib.db")
        with seeded_uuid4():
            _seed_library(pkg, ctx, pathlib.Path("/library/media"))
        out[pkg.name] = ctx
    return out


@pytest.mark.parametrize("threshold", [0.45, 0.2, 1e-4])
def test_people_cluster_as_jax(libraries, threshold):
    got = port_people.cluster_people(libraries["port"], threshold)
    want = jax_people.cluster_people(libraries["jax"], threshold)
    assert got == want and got
    if threshold == 0.45:  # the three seeded identities
        assert len(got) == 3 and got[0]["video_count"] == 2
    memo = port_people.PeopleService(libraries["port"])
    assert memo.people(threshold) == got and memo.people(threshold) is memo.people(threshold)


SEGMENTS = [
    {"span_start_ms": 0, "span_end_ms": 1500, "payload_json": {"text": "hello world"}},
    {"span_start_ms": 3_723_004, "span_end_ms": 3_723_004,
     "payload_json": {"text": "zero-length span", "speaker": "SPEAKER_1"}},
    {"span_start_ms": 1500, "span_end_ms": 2000,
     "payload_json": {"text": "a --> b & <i>tag</i>\n\nline", "speaker": "A & B"}},
    {"span_start_ms": 2500, "span_end_ms": 3000, "payload_json": {"text": "   "}},
    {"span_start_ms": -5, "span_end_ms": 900, "payload_json": {}},
]


@pytest.mark.parametrize("fmt", ["to_vtt", "to_srt"])
@pytest.mark.parametrize("segments", [SEGMENTS, SEGMENTS[:1], []], ids=["all", "one", "none"])
def test_subtitles_byte_equal(fmt, segments):
    got = getattr(port_subtitles, fmt)(json.loads(json.dumps(segments)))
    assert got == getattr(jax_subtitles, fmt)(json.loads(json.dumps(segments)))
    assert got.encode() == getattr(jax_subtitles, fmt)(segments).encode()


# ---------------------------------------------------------------------------
# dump, import-eioku


def _dump_records(path: pathlib.Path) -> list[dict]:
    with gzip.open(path, "rt") as f:
        records = [json.loads(line) for line in f]
    for r in records:
        for k in TIME_FIELDS:
            r["data"].pop(k, None)
    return records


@pytest.mark.parametrize("exporter", ["jax", "port"])
def test_dump_round_trip_across_packages(libraries, exporter, tmp_path):
    """The exporter's dump equals the other package's dump of the same
    library, and imports into either package to equal rows."""
    dumps = {}
    for pkg in (JAX, PORT):
        dumps[pkg.name] = tmp_path / f"{pkg.name}.jsonl.gz"
        counts = SERVICES[pkg.name][2].export_dump(libraries[pkg.name],
                                                   str(dumps[pkg.name]))
        assert counts["artifacts"] == 3 + 3 + 17
    assert _dump_records(dumps["port"]) == _dump_records(dumps["jax"])
    rows = {}
    for pkg in (JAX, PORT):
        ctx = _context(pkg, tmp_path / f"restored_{pkg.name}.db")
        with seeded_uuid4():
            counts = SERVICES[pkg.name][2].import_dump(ctx, str(dumps[exporter]))
        rows[pkg.name] = (counts, _all_rows(ctx))
    assert rows["port"] == rows["jax"]
    counts, restored = rows["port"]
    assert counts["reindex_enqueued"] == 1 and len(restored["artifacts"]) == 23
    assert ("process_ml_task", "semantic_indexing", "v0") in restored["jobs"]


def test_import_eioku_as_jax(tmp_path):
    source = tmp_path / "eioku.db"
    make_reference_db(str(source))
    rows = {}
    for pkg in (JAX, PORT):
        ctx = _context(pkg, tmp_path / f"{pkg.name}.db")
        with seeded_uuid4():
            counts = SERVICES[pkg.name][3].import_reference_db(ctx, str(source))
            again = SERVICES[pkg.name][3].import_reference_db(ctx, str(source))  # idempotent
        rows[pkg.name] = (counts, again, _all_rows(ctx))
    assert rows["port"] == rows["jax"]
    counts, again, imported = rows["port"]
    assert counts["videos"] == 2 and again["videos"] == again["artifacts"] == 0
    assert again["skipped_existing"] >= 2 + 5
    assert len(imported["artifacts"]) == 5 and imported["transcript_fts"]


# ---------------------------------------------------------------------------
# clips


@contextlib.contextmanager
def cv2_clips():
    """Both packages' clip export on its cv2 re-encode path, the only one on
    a host without libavformat."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_audio_io, "native_decoder", lambda: None)
        mp.setattr(port_audio_io, "native_decoder", lambda: None)
        yield


def _frames(path: pathlib.Path) -> int:
    cap = cv2.VideoCapture(str(path))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


@pytest.mark.parametrize("span", [(0, 1000), (500, 2000), (2500, 9000), (900, 900)])
def test_export_clip_cv2_frames_as_jax(tmp_path, span):
    from test_torch_visual import _write_clip
    src = tmp_path / "src.mp4"
    _write_clip(str(src), 30, seed=4)
    ok = {}
    with cv2_clips():
        for name, export in (("jax", jax_export_clip), ("port", port_export_clip)):
            ok[name] = export(str(src), str(tmp_path / f"{name}.mp4"), *span)
    assert ok["port"] == ok["jax"] == (span[1] > span[0])
    if ok["port"]:
        assert _frames(tmp_path / "port.mp4") == _frames(tmp_path / "jax.mp4") > 0


# ---------------------------------------------------------------------------
# the ops CLI

CLI_RUNS = [  # (name, argv after the global options); run in this order
    ("videos", ["videos"]),
    ("tasks", ["tasks"]),
    ("stats", ["stats"]),
    ("people", ["people", "--threshold", "0.45"]),
    ("search", ["search", "harbour boat anchor", "--top-k", "3"]),
    ("resync", ["resync"]),
    ("reconcile", ["reconcile"]),
    ("export_clip", ["export-clip", "vid-a", "{out}/clip.mp4", "--start-ms", "500",
                     "--end-ms", "2000"]),
    ("export_clip_missing", ["export-clip", "nope", "{out}/x.mp4", "--end-ms", "10"]),
    ("import_eioku", ["import-eioku", "--source", "{out}/eioku.db"]),
    ("export_dump", ["export-dump", "--out", "{out}/lib.jsonl.gz"]),
    ("import_dump", ["--db", "sqlite:///{out}/fresh.db", "import-dump", "--source",
                     "{out}/lib.jsonl.gz"]),
    ("extract_audio", ["extract-audio", "{lib}/talk.mp4", "{out}/talk.wav"]),
    ("discover", ["discover"]),
    ("videos_after", ["videos"]),
]


def _cli_library(base: pathlib.Path) -> pathlib.Path:
    """One library, seeded through the port (tests/test_torch_api.py's
    seeding: transcripts and their semantic index, faces, scenes, tasks, the
    tiny CLIP keyframe index), closed, to be copied for each package."""
    import jax

    from eioku_tpu.models.clip import model as jax_clip
    from eioku_tpu_torch.models.clip import model as port_clip
    from eioku_tpu_torch.models.layers import load_state

    inputs = base / "inputs"
    _write_inputs(inputs)
    src = base / "source"
    (src / "library").mkdir(parents=True)
    shutil.copy(inputs / "scanned.mp4", src / "library" / "scanned.mp4")
    shutil.copy(inputs / "media" / "a.mp4", src / "talk.mp4")
    t = np.arange(16000 * 2) / 16000
    scipy.io.wavfile.write(src / "talk.wav", 16000,
                           (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32))
    port_model = load_state(port_clip.CLIP(PORT_TINY), port_clip.from_jax_params(
        jax.tree_util.tree_map(np.asarray, jax_clip.init_clip_params(TINY, seed=0)))).eval()
    cfg = PORT.config_cls(scan_paths=[], auto_discover=False,
                          model_cache_dir=str(inputs / "models"))
    with seeded_uuid4():
        ctx = PORT.build_context(cfg, db=PORT.database_cls(f"sqlite:///{src}/eioku.db"),
                                 device="cpu")
        _tiny_clip(PORT, ctx.extra["visual_index"], None, port_model)
        _seed(PORT, ctx, inputs)
    ctx.db.close()
    (src / "cfg.json").write_text(json.dumps({
        "paths": [str(base / "lib" / "library")], "model_cache_dir": str(inputs / "models"),
        "active_task_types": ["scene_detection"]}))
    return src


def _run_cli(main, lib: pathlib.Path, out: pathlib.Path) -> dict:
    results = {}
    for name, argv in CLI_RUNS:
        argv = [a.format(out=out, lib=lib) for a in argv]
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout), \
                pytest.MonkeyPatch.context() as mp:
            mp.setattr(sys, "argv", ["eioku", "--db", f"sqlite:///{lib}/eioku.db",
                                     "--config", str(lib / "cfg.json")] + argv)
            rc = main()
        results[name] = (rc, stdout.getvalue())
    results["files"] = {
        "clip_frames": _frames(out / "clip.mp4"),
        "dump": _dump_records(out / "lib.jsonl.gz"),
        "wav": (out / "talk.wav").read_bytes(),
        "fresh_rows": _all_rows(_context(PORT, out / "fresh.db"))}
    return results


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli")
    src = _cli_library(base)
    lib, out = base / "lib", base / "out"
    runs = {}
    with cv2_clips(), pytest.MonkeyPatch.context() as mp:
        mp.setenv("EIOKU_FORCE_CPU", "1")
        for name, main in (("jax", jax_cli.main), ("port", port_cli.main)):
            shutil.copytree(src, lib)
            out.mkdir()
            make_reference_db(str(out / "eioku.db"))
            with seeded_uuid4():
                runs[name] = _run_cli(main, lib, out)
            lib.rename(base / f"lib_{name}")
            out.rename(base / f"out_{name}")
    return runs


def _search_lines(text: str) -> list[tuple[float, str]]:
    return [(float(line.split("  ", 1)[0]), line.split("  ", 1)[1])
            for line in text.splitlines()]


@pytest.mark.parametrize("name", [r[0] for r in CLI_RUNS])
def test_cli_command_as_jax(cli_runs, name):
    (rc, got), (want_rc, want) = cli_runs["port"][name], cli_runs["jax"][name]
    assert rc == want_rc
    if name == "search":
        got, want = _search_lines(got), _search_lines(want)
        scores = [s for s, _ in want]
        assert len(got) == len(want) == 3
        # hazard k: the hits keep more than the bf16 tolerance apart
        assert all(a - b > SCORE_TOL for a, b in zip(scores, scores[1:])), scores
        for (gs, g), (ws, w) in zip(got, want):
            assert g == w and abs(gs - ws) <= SCORE_TOL + 1e-3  # printed to 3 decimals
    else:
        assert got == want
    assert rc == (1 if name == "export_clip_missing" else 0)


@pytest.mark.parametrize("part", ["clip_frames", "dump", "wav", "fresh_rows"])
def test_cli_files_as_jax(cli_runs, part):
    got, want = cli_runs["port"]["files"][part], cli_runs["jax"]["files"][part]
    assert got == want and got


def test_cli_finetune_as_jax(tmp_path, monkeypatch, capsys):
    """`finetune` (refused by the port before) through both CLIs on one
    library of seeded chunks, with both packages' MiniLM loader patched to
    tests/test_torch_finetune.py's small seeded tree: the same stats, losses
    within its LOSS_RTOL and LOSS_ATOL, and each checkpoint where its package saves it."""
    import jax

    import eioku_tpu.parallel.finetune as jax_ft
    import eioku_tpu_torch.parallel.finetune as port_ft
    import test_torch_finetune as ft
    from eioku_tpu.models.embed import minilm as jml
    from eioku_tpu_torch.models.embed import minilm as pml

    tree = ft.tree.__wrapped__()
    jcfg, pcfg = jml.MiniLMConfig(**ft.TINY), pml.MiniLMConfig(**ft.TINY)
    monkeypatch.setattr(jax_ft, "load_minilm", lambda cache: (
        jax.tree.map(jax.numpy.asarray, tree), jcfg, False))
    monkeypatch.setattr(port_ft, "load_minilm", lambda cache, device="cpu": (
        ft._port_model(tree).to(device), pcfg, False))
    monkeypatch.setenv("EIOKU_FORCE_CPU", "1")
    url = ft.corpus.__wrapped__(tmp_path)
    stats = {}
    for name, main in (("jax", jax_cli.main), ("port", port_cli.main)):
        cfg = tmp_path / f"{name}.json"
        cfg.write_text(json.dumps({"paths": [], "model_cache_dir": str(tmp_path / name),
                                   "semantic_search": False, "visual_search": False}))
        monkeypatch.setattr(sys, "argv", [
            "eioku", "--db", url, "--config", str(cfg), "finetune", "--steps",
            str(ft.STEPS), "--batch-size", str(ft.BATCH), "--lr", str(ft.LR)])
        capsys.readouterr()
        assert main() == 0
        stats[name] = json.loads(capsys.readouterr().out)
    got, want = stats["port"], stats["jax"]
    assert set(got) == set(want)
    assert (got["steps"], got["chunks"]) == (want["steps"], want["chunks"]) == (ft.STEPS, 24)
    for k in ("first_loss", "last_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=ft.LOSS_RTOL, atol=ft.LOSS_ATOL)
    for name in ("jax", "port"):
        assert stats[name]["checkpoint"] == str(tmp_path / name / "minilm-l6" / "native.npz")
        assert pathlib.Path(stats[name]["checkpoint"]).is_file()


@pytest.mark.parametrize("search", [{}, {"semantic_search": False},
                                    {"visual_search": False}])
def test_cli_without_cuda_raises_at_start(tmp_path, monkeypatch, search):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"paths": [], **search}))
    monkeypatch.delenv("EIOKU_FORCE_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["eioku", "--db", f"sqlite:///{tmp_path}/e.db",
                                      "--config", str(cfg), "videos"])
    with pytest.raises(RuntimeError, match="CUDA is not available.*EIOKU_FORCE_CPU"):
        port_cli.main()


@pytest.mark.parametrize("env,search", [
    ("1", {}), (None, {"semantic_search": False, "visual_search": False})])
def test_cli_runs_on_the_cpu_only_when_asked_or_without_search(
        tmp_path, monkeypatch, capsys, env, search):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"paths": [], **search}))
    if env:
        monkeypatch.setenv("EIOKU_FORCE_CPU", env)
    else:
        monkeypatch.delenv("EIOKU_FORCE_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["eioku", "--db", f"sqlite:///{tmp_path}/e.db",
                                      "--config", str(cfg), "stats"])
    assert port_cli.main() == 0
    assert json.loads(capsys.readouterr().out)["videos"]["total"] == 0
