"""Configuration system: env vars + JSON config files + per-task profiles.

Copy of eioku_tpu/config/settings.py for the PyTorch port.

Capability parity: backend/src/services/config_loader.py:11-86
(config file search order: explicit --config arg -> EIOKU_CONFIG_PATH ->
~/.eioku/config.json -> /etc/eioku/config.json -> defaults) and
video_discovery_service.py:371-443 (hardcoded per-task defaults merged with a
profile file's task_settings). The reference's profile JSONs
(config/content_creator.json etc.) carry model names, sampling intervals,
confidence thresholds, and languages per task type.
"""
from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from typing import Any

log = logging.getLogger(__name__)

DEFAULT_SCAN_PATHS = ["~/Videos", "/media", "/mnt"]

# Hardcoded per-task defaults (reference: video_discovery_service.py:399-430 and
# model_manager.py:230-232,324-326,423,499,645,732).
DEFAULT_TASK_SETTINGS: dict[str, dict[str, Any]] = {
    "object_detection": {"model": "yolov8n", "confidence_threshold": 0.5,
                         "frame_interval_s": 1.0, "batch_size": 64},
    "face_detection": {"model": "yolov8n-face", "confidence_threshold": 0.7,
                       "frame_interval_s": 3.0, "batch_size": 64},
    "transcription": {"model": "whisper-large-v3", "languages": [],
                      "vad_filter": True, "chunk_s": 30.0, "beam_size": 5,
                      "no_speech_threshold": 0.6, "logprob_threshold": -1.0},
    "ocr": {"languages": ["en"], "frame_interval_s": 2.0, "batch_size": 16},
    "place_classification": {"model": "resnet18-places365", "top_k": 5,
                             "frame_interval_s": 1.0, "batch_size": 64},
    "scene_detection": {"threshold": 0.1, "min_scene_len_s": 0.5, "sample_fps": 4.0},
    "metadata_extraction": {},
    "semantic_indexing": {"model": "minilm-l6", "chunk_chars": 400, "overlap_chars": 80},
    "speaker_diarization": {"window_s": 1.5, "hop_s": 0.75, "vad_filter": True,
                            "distance_threshold": 0.45, "batch_size": 32},
}


# Workload profiles -> per-task-type queue priorities (1 = highest). The
# reference's profile `workers:` sections were dead config
# (video_discovery_service.py loads only task_settings); here profiles actually
# shape scheduling: search-first drains transcription/semantic work before
# visual tasks, visual-first the reverse (BASELINE.json
# "Balanced/Search-First/Visual-First").
WORKLOAD_PROFILES: dict[str, dict[str, int]] = {
    "balanced": {},
    "search_first": {"metadata_extraction": 1, "transcription": 2,
                     "semantic_indexing": 3, "ocr": 4, "scene_detection": 5,
                     "speaker_diarization": 5, "object_detection": 7,
                     "face_detection": 7, "place_classification": 8},
    "visual_first": {"metadata_extraction": 1, "scene_detection": 2,
                     "object_detection": 3, "face_detection": 3,
                     "place_classification": 4, "ocr": 5, "transcription": 7,
                     "semantic_indexing": 8, "speaker_diarization": 8},
}


@dataclass
class AppConfig:
    scan_paths: list[str] = field(default_factory=lambda: list(DEFAULT_SCAN_PATHS))
    recursive: bool = True
    # per-path recursive overrides from object-form "paths" config entries
    path_recursive: dict[str, bool] = field(default_factory=dict)
    database_url: str | None = None
    model_profile: str = "balanced"
    profile_name: str | None = None
    task_settings: dict[str, dict[str, Any]] = field(default_factory=dict)
    active_task_types: list[str] | None = None
    model_cache_dir: str | None = None
    index_dir: str | None = None
    reconcile_interval_s: float = 300.0
    auto_discover: bool = True
    # opt-in periodic re-scan of the configured paths (seconds; None = only
    # at startup / via POST /paths/discover, like the reference): new files
    # dropped into a watched folder get discovered and enqueued automatically
    discover_interval_s: float | None = None
    semantic_search: bool = True
    # CLIP text->keyframe retrieval (/search?mode=visual): scene keyframes
    # embedded by the image tower, queries by the text tower
    visual_search: bool = True

    # int8-quantized MiniLM serving for the semantic index (ops/quant.py):
    # the MXU's double-rate int8 path, ~1e-3 cosine deviation
    embed_int8: bool = False

    workload_profile: str = "balanced"
    # one visual_analysis task (single decode pass) instead of the four
    # frame-based visual tasks
    combined_visual: bool = False

    def settings_for(self, task_type: str) -> dict[str, Any]:
        merged = dict(DEFAULT_TASK_SETTINGS.get(task_type, {}))
        merged.update(normalize_task_settings(
            self.task_settings.get(task_type, {})))
        return merged

    def priority_for(self, task_type: str, default: int) -> int:
        return WORKLOAD_PROFILES.get(self.workload_profile, {}).get(
            task_type, default)


# Reference-config compatibility: the reference's profile JSONs
# (config/content_creator.json, video_discovery_service.py:371-443)
# spell several task_settings keys differently. Accept both spellings so a
# reference user's config file works unmodified (docs/MIGRATION.md).
_TASK_TYPE_ALIASES = {"place_detection": "place_classification"}
_TASK_KEY_ALIASES = {
    "model_name": "model",                       # "yolov8s.pt" / "large-v3-turbo"
    "sampling_interval_seconds": "frame_interval_s",
    "min_scene_length": "min_scene_len_s",
}


def normalize_task_settings(raw: dict[str, Any]) -> dict[str, Any]:
    """Rewrite one task's settings dict from reference spellings to ours.

    Ours-spelled keys pass through untouched and win over an alias if both are
    present. Model names drop the ultralytics ``.pt`` suffix ("yolov8s.pt" ->
    "yolov8s"); whisper variants like "large-v3-turbo" are already accepted by
    ml/transcribe._normalize_variant.
    """
    out: dict[str, Any] = {}
    for key, val in raw.items():
        nk = _TASK_KEY_ALIASES.get(key, key)
        if nk != key and nk in raw:
            continue  # natively-spelled key also present — it wins
        if nk == "model" and isinstance(val, str) and val.endswith(".pt"):
            val = val[:-3]
        out[nk] = val
    return out


# Scene-threshold scale divide: the reference passes `threshold` to ffmpeg
# scene-cut (default 0.7 on ffmpeg's SAD scale, model_manager.py:715-835); our
# HSV mean-abs-diff metric's equivalent default is 0.1 (ops/scene_diff.py,
# scores in [0,1] where real cuts land ~0.1-0.3). Any threshold above this
# bound would detect almost nothing here, so it can only be a carried-over
# ffmpeg-scale value — rescale it proportionally to preserve the user's
# stricter/looser-than-default intent instead of silently breaking detection.
_SCENE_FFMPEG_SCALE_MIN = 0.3
_SCENE_RESCALE = 0.1 / 0.7  # ours-default / reference-default


def normalize_task_settings_map(raw: dict[str, Any]) -> dict[str, dict[str, Any]]:
    """Normalize a whole ``task_settings`` mapping: task-type aliases
    (place_detection -> place_classification) and non-dict scalar entries the
    reference nests there (e.g. ``max_concurrent_videos``) are handled; scalars
    are dropped from the per-task map (worker concurrency is WORKER_MAX_JOBS
    here, docs/DEPLOY.md)."""
    out: dict[str, dict[str, Any]] = {}
    for ttype, settings in raw.items():
        if not isinstance(settings, dict):
            continue
        settings = dict(settings)
        ttype = _TASK_TYPE_ALIASES.get(ttype, ttype)
        thr = settings.get("threshold")
        if (ttype == "scene_detection" and isinstance(thr, (int, float))
                and thr >= _SCENE_FFMPEG_SCALE_MIN):
            settings["threshold"] = round(thr * _SCENE_RESCALE, 4)
            log.warning(
                "scene_detection threshold %.2f looks like the reference's "
                "ffmpeg scene-cut scale (our HSV frame-diff default is 0.1); "
                "rescaled to %.4f — set a value below %.1f to silence this",
                thr, settings["threshold"], _SCENE_FFMPEG_SCALE_MIN)
        out[ttype] = settings
    return out


def _search_config_path(explicit: str | None) -> str | None:
    # an explicitly requested config must exist — silently falling back to
    # env/home/system configs would run against the wrong paths/database
    if explicit:
        if not os.path.isfile(explicit):
            raise FileNotFoundError(f"config file not found: {explicit}")
        return explicit
    candidates = []
    env = os.environ.get("EIOKU_CONFIG_PATH")
    if env:
        candidates.append(env)
    candidates.append(os.path.expanduser("~/.eioku/config.json"))
    candidates.append("/etc/eioku/config.json")
    for c in candidates:
        if os.path.isfile(c):
            return c
    return None


def load_config(explicit_path: str | None = None) -> AppConfig:
    cfg = AppConfig()
    path = _search_config_path(explicit_path)
    if path is not None:
        with open(path) as f:
            data = json.load(f)
        # "paths" entries are either plain strings or, as in the reference's
        # config format, objects {"path": ..., "recursive": bool}
        # (reference: config_loader.py:60-71, config/eioku.json)
        raw_paths = data.get("paths", data.get("scan_paths", cfg.scan_paths))
        cfg.scan_paths = []
        for entry in raw_paths:
            if isinstance(entry, dict):
                p = entry.get("path")
                if not p:
                    continue
                p = os.path.expanduser(p)
                # only an explicit per-path value overrides the file-level
                # "recursive" flag (entries without one fall back to it)
                if "recursive" in entry:
                    cfg.path_recursive[p] = bool(entry["recursive"])
            else:
                p = os.path.expanduser(entry)
            cfg.scan_paths.append(p)
        cfg.recursive = data.get("recursive", cfg.recursive)
        cfg.database_url = data.get("database_url", cfg.database_url)
        cfg.model_profile = data.get("model_profile", cfg.model_profile)
        cfg.profile_name = data.get("profile", cfg.profile_name)
        cfg.task_settings = normalize_task_settings_map(
            data.get("task_settings", {}))
        cfg.active_task_types = data.get("active_task_types")
        cfg.model_cache_dir = data.get("model_cache_dir")
        cfg.index_dir = data.get("index_dir")
        cfg.auto_discover = data.get("auto_discover", cfg.auto_discover)
        raw_di = data.get("discover_interval_s")
        try:
            di = float(raw_di) if raw_di else None
        except (TypeError, ValueError):
            log.warning("discover_interval_s %r is not a number; periodic "
                        "discovery disabled", raw_di)
            di = None
        if di is not None and di <= 0:
            log.warning("discover_interval_s %s <= 0; periodic discovery "
                        "disabled", di)
            di = None
        cfg.discover_interval_s = di
        cfg.semantic_search = data.get("semantic_search", cfg.semantic_search)
        cfg.visual_search = data.get("visual_search", cfg.visual_search)
        cfg.embed_int8 = data.get("embed_int8", cfg.embed_int8)
        cfg.workload_profile = data.get("workload_profile", cfg.workload_profile)
        cfg.combined_visual = data.get("combined_visual", cfg.combined_visual)
        log.info("loaded config", extra={"config_path": path})
    if os.environ.get("EIOKU_DATABASE_URL"):
        cfg.database_url = os.environ["EIOKU_DATABASE_URL"]
    if os.environ.get("MODEL_CACHE_DIR"):
        cfg.model_cache_dir = os.environ["MODEL_CACHE_DIR"]
    return cfg
