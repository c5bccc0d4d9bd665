"""Inference engine: task-type dispatch into the port's device paths
(port of eioku_tpu/ml/engine.py).

Same dispatch keys as the JAX engine. The port implements
scene_detection, object_detection, visual_analysis (scenes + objects) and
transcription; every other task type raises ModelNotAvailable, which the
task handler records as a clean task failure.

Results are lists of {"payload": dict, "span_start_ms": int,
"span_end_ms": int}; visual_analysis returns {sub_task_type: results}.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from eioku_tpu_torch.utils.device import resolve_device


class ModelNotAvailable(RuntimeError):
    pass


def device_info() -> dict:
    """CUDA device introspection, with the JAX engine's "unavailable"
    contract when no card answers."""
    unavailable = {"backend": "unavailable", "device_count": 0, "devices": [],
                   "error": "device backend unreachable"}
    try:
        if not torch.cuda.is_available():
            return unavailable
        count = torch.cuda.device_count()
        return {
            "backend": "cuda",
            "device_count": count,
            "devices": [{"id": i, "kind": torch.cuda.get_device_name(i),
                         "platform": "gpu"} for i in range(count)],
        }
    except RuntimeError:
        return unavailable


_TASK_TYPES = (
    "scene_detection", "metadata_extraction", "object_detection",
    "face_detection", "transcription", "ocr", "place_classification",
    "semantic_indexing", "visual_analysis", "speaker_diarization",
)


class InferenceEngine:
    def __init__(self, model_cache_dir: str | None = None,
                 model_profile: str = "balanced",
                 device: str | torch.device | None = None):
        self.model_cache_dir = model_cache_dir
        self.model_profile = model_profile
        self.device = resolve_device(device)
        ported = {
            "scene_detection": self._scene_detection,
            "object_detection": self._object_detection,
            "visual_analysis": self._visual_analysis,
            "transcription": self._transcription,
        }
        self._dispatch: dict[str, Callable[[str, dict], Any]] = {
            t: ported.get(t, self._not_ported(t)) for t in _TASK_TYPES}
        self.producer_name = "eioku-tpu-torch-engine"
        self.producer_version = "0.1.0"

    def run_task(self, task_type: str, video_path: str,
                 config: dict[str, Any]) -> list[dict] | dict:
        fn = self._dispatch.get(task_type)
        if fn is None:
            raise ModelNotAvailable(f"unknown task type {task_type!r}")
        return fn(video_path, config or {})

    @staticmethod
    def _not_ported(task_type: str) -> Callable[[str, dict], Any]:
        def fail(video_path: str, config: dict):
            raise ModelNotAvailable(
                f"task type {task_type!r} is not ported to eioku_tpu_torch yet")
        return fail

    def _scene_detection(self, video_path: str, config: dict) -> list[dict]:
        from eioku_tpu_torch.ml.scenes import detect_scenes, scene_rows
        return scene_rows(detect_scenes(
            video_path,
            threshold=float(config.get("threshold", 0.1)),
            min_scene_len_s=float(config.get("min_scene_len_s", 0.5)),
            sample_fps=float(config.get("sample_fps", 4.0)),
            batch_size=int(config.get("batch_size", 64)),
            decode_threads=int(config.get("decode_threads", 4)),
            decode_procs=int(config.get("decode_procs", 0)),
            decode_fast=int(config.get("decode_fast", 1)),
            device=self.device,
        ))

    def _object_detection(self, video_path: str, config: dict) -> list[dict]:
        from eioku_tpu_torch.ml.detection import run_object_detection
        return run_object_detection(video_path, config,
                                    model_cache_dir=self.model_cache_dir,
                                    device=self.device)

    def _visual_analysis(self, video_path: str, config: dict) -> dict:
        """Combined one-decode-pass pipeline; returns {sub_task_type: results}."""
        from eioku_tpu_torch.ml.combined import run_visual_analysis
        return run_visual_analysis(video_path, config,
                                   model_cache_dir=self.model_cache_dir,
                                   device=self.device)

    def _transcription(self, video_path: str, config: dict) -> list[dict]:
        from eioku_tpu_torch.ml.transcribe import run_transcription
        return run_transcription(video_path, config,
                                 model_cache_dir=self.model_cache_dir,
                                 device=self.device)
