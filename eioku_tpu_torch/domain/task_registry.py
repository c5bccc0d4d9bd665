"""Task-type registry: the 7 analysis task types + semantic indexing.

Copy of eioku_tpu/domain/task_registry.py for the PyTorch port.

Capability parity: backend/src/domain/task_registry.py:17-45
(language mode per task type) and video_discovery_service.py:21-29
(ACTIVE_TASK_TYPES). This rebuild adds `semantic_indexing` — the embedding +
retrieval layer the reference spec'd but never shipped.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass


class LanguageMode(str, enum.Enum):
    NONE = "none"          # language-agnostic
    OPTIONAL = "optional"  # may specify language; None = auto-detect
    REQUIRED = "required"  # one task per configured language


@dataclass(frozen=True)
class TaskTypeSpec:
    name: str
    language_mode: LanguageMode
    artifact_types: tuple[str, ...]
    uses_tpu: bool
    default_priority: int = 5


TASK_REGISTRY: dict[str, TaskTypeSpec] = {
    s.name: s
    for s in [
        TaskTypeSpec("object_detection", LanguageMode.NONE, ("object.detection",), True),
        TaskTypeSpec("face_detection", LanguageMode.NONE, ("face.detection",), True),
        TaskTypeSpec("transcription", LanguageMode.OPTIONAL, ("transcript.segment",), True),
        TaskTypeSpec("ocr", LanguageMode.REQUIRED, ("ocr.text",), True),
        TaskTypeSpec("place_classification", LanguageMode.NONE, ("place.classification",), True),
        TaskTypeSpec("scene_detection", LanguageMode.NONE, ("scene",), True),
        TaskTypeSpec("metadata_extraction", LanguageMode.NONE, ("video.metadata",), False,
                     2),  # cheap + others benefit from duration: run early
        TaskTypeSpec("semantic_indexing", LanguageMode.NONE, ("embedding.chunk",), True, 7),
        # beyond the reference: CLIP text->keyframe retrieval; enqueued by the
        # task handler after scene detection completes (like semantic after
        # transcription). Produces index rows (frame_embeddings), not
        # artifacts — fully derived, rebuildable state.
        TaskTypeSpec("visual_indexing", LanguageMode.NONE, (), True, 7),
        # beyond the reference: who-spoke-when turns (opt-in via
        # active_task_types; ECAPA-TDNN embeddings + clustering)
        TaskTypeSpec("speaker_diarization", LanguageMode.NONE, ("speaker.turn",), True, 6),
        # one-decode-pass replacement for the frame-based visual tasks,
        # including OCR when active (enable with combined_visual: true;
        # see eioku_tpu/ml/combined.py)
        TaskTypeSpec("visual_analysis", LanguageMode.NONE,
                     ("scene", "object.detection", "face.detection",
                      "place.classification", "ocr.text"), True, 3),
    ]
}

# Task types auto-created per discovered video (reference fans out 7; we fan out 8
# including the semantic layer; semantic_indexing depends on transcription artifacts
# and is enqueued by the task handler after transcription completes).
ACTIVE_TASK_TYPES: tuple[str, ...] = (
    "metadata_extraction",
    "scene_detection",
    "object_detection",
    "face_detection",
    "transcription",
    "ocr",
    "place_classification",
)

SUPPORTED_TASK_TYPES: tuple[str, ...] = tuple(TASK_REGISTRY.keys())


def is_language_required(task_type: str) -> bool:
    return TASK_REGISTRY[task_type].language_mode is LanguageMode.REQUIRED


def is_language_optional(task_type: str) -> bool:
    return TASK_REGISTRY[task_type].language_mode is LanguageMode.OPTIONAL


def is_language_agnostic(task_type: str) -> bool:
    return TASK_REGISTRY[task_type].language_mode is LanguageMode.NONE
