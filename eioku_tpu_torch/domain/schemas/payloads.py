"""Pydantic payload models, version 1.

Copy of eioku_tpu/domain/schemas/payloads.py for the PyTorch port.

Each model corresponds to one (artifact_type, schema_version=1) registry entry.
Capability parity sources in the reference:
  - transcript.segment: backend/src/domain/schemas/transcript.py:1-61
  - scene:              backend/src/domain/schemas/scene.py:1-35
  - object.detection:   backend/src/domain/schemas/object.py:1-55
  - face.detection:     backend/src/domain/schemas/face.py:1-60
  - ocr.text:           backend/src/domain/schemas/ocr_text.py:1-45
  - place.classification: backend/src/domain/schemas/place.py:1-50
  - video.metadata:     backend/src/domain/schemas/metadata.py:1-91
  - embedding.chunk:    new in this rebuild (semantic layer)
"""
from __future__ import annotations

from pydantic import BaseModel, Field, field_validator


class BoundingBox(BaseModel):
    """Axis-aligned box in pixel coordinates, (x, y) top-left + width/height."""

    x: float
    y: float
    width: float = Field(ge=0)
    height: float = Field(ge=0)


class WordTiming(BaseModel):
    word: str
    start_ms: int = Field(ge=0)
    end_ms: int = Field(ge=0)
    confidence: float | None = Field(default=None, ge=0.0, le=1.0)


class TranscriptSegmentV1(BaseModel):
    text: str
    language: str | None = None
    start_ms: int = Field(ge=0)
    end_ms: int = Field(ge=0)
    confidence: float | None = Field(default=None, ge=0.0, le=1.0)
    words: list[WordTiming] = Field(default_factory=list)

    @field_validator("end_ms")
    @classmethod
    def _end_after_start(cls, v: int, info):
        start = info.data.get("start_ms")
        if start is not None and v < start:
            raise ValueError("end_ms must be >= start_ms")
        return v


class SceneV1(BaseModel):
    scene_index: int = Field(ge=0)
    start_ms: int = Field(ge=0)
    end_ms: int = Field(ge=0)
    duration_ms: int = Field(ge=0)
    score: float | None = None  # boundary strength (new: the TPU kernel emits it)


class ObjectDetectionV1(BaseModel):
    label: str
    confidence: float = Field(ge=0.0, le=1.0)
    bounding_box: BoundingBox
    frame_number: int = Field(ge=0)


class FaceDetectionV1(BaseModel):
    cluster_id: str | None = None
    confidence: float = Field(ge=0.0, le=1.0)
    bounding_box: BoundingBox
    frame_number: int = Field(ge=0)
    embedding: list[float] | None = None  # new: enables face clustering downstream


class OcrTextV1(BaseModel):
    text: str
    confidence: float | None = Field(default=None, ge=0.0, le=1.0)
    polygon: list[list[float]] = Field(min_length=3)
    languages: list[str] = Field(default_factory=list)
    frame_index: int = Field(ge=0)

    @field_validator("polygon")
    @classmethod
    def _points_are_pairs(cls, v: list[list[float]]):
        for pt in v:
            if len(pt) != 2:
                raise ValueError("polygon points must be [x, y] pairs")
        return v


class PlacePrediction(BaseModel):
    label: str
    confidence: float = Field(ge=0.0, le=1.0)


class PlaceClassificationV1(BaseModel):
    predictions: list[PlacePrediction] = Field(min_length=1)
    frame_number: int = Field(ge=0)


class GpsCoordinates(BaseModel):
    latitude: float = Field(ge=-90, le=90)
    longitude: float = Field(ge=-180, le=180)
    altitude: float | None = None


class MetadataV1(BaseModel):
    duration_ms: int | None = Field(default=None, ge=0)
    width: int | None = Field(default=None, ge=0)
    height: int | None = Field(default=None, ge=0)
    fps: float | None = Field(default=None, ge=0)
    codec: str | None = None
    bitrate: int | None = None
    create_date: str | None = None  # ISO 8601
    camera_make: str | None = None
    camera_model: str | None = None
    gps: GpsCoordinates | None = None
    container: str | None = None
    audio_codec: str | None = None
    audio_channels: int | None = None
    audio_sample_rate: int | None = None
    extra: dict = Field(default_factory=dict)


class SpeakerTurnV1(BaseModel):
    """A contiguous span attributed to one speaker (beyond the reference:
    diarization via ECAPA-TDNN embeddings + clustering, eioku_tpu/ml/diarize.py).
    `label` is the cluster name (SPEAKER_00...), so jump navigation's generic
    label filter works for kind=speaker."""

    label: str
    start_ms: int = Field(ge=0)
    end_ms: int = Field(ge=0)
    confidence: float = Field(ge=0.0, le=1.0)

    @field_validator("end_ms")
    @classmethod
    def _end_after_start(cls, v: int, info):
        start = info.data.get("start_ms")
        if start is not None and v < start:
            raise ValueError("end_ms must be >= start_ms")
        return v


class EmbeddingChunkV1(BaseModel):
    """A dense embedding of a transcript/OCR chunk for semantic retrieval.

    The vector itself lives in the TPU-side index (eioku_tpu_torch.index); the artifact
    records the chunk text, provenance, and the index slot so results can be
    mapped back to time spans.
    """

    text: str
    source: str  # "transcript" | "ocr"
    model: str
    dim: int = Field(ge=1)
    index_slot: int = Field(ge=0)
    norm: float | None = None
