"""Versioned payload schemas for artifact envelopes.

Copy of eioku_tpu/domain/schemas/__init__.py for the PyTorch port.

Capability parity with the reference's 8 payload schemas
(backend/src/domain/schemas/*.py), plus one new schema for the
semantic-embedding layer the reference spec'd but never shipped
(reference: .kiro/specs/semantic-video-search/requirements.md).
"""
from eioku_tpu_torch.domain.schemas.payloads import (
    BoundingBox,
    EmbeddingChunkV1,
    FaceDetectionV1,
    MetadataV1,
    ObjectDetectionV1,
    OcrTextV1,
    PlaceClassificationV1,
    PlacePrediction,
    SceneV1,
    SpeakerTurnV1,
    TranscriptSegmentV1,
    WordTiming,
)

__all__ = [
    "BoundingBox",
    "WordTiming",
    "TranscriptSegmentV1",
    "SceneV1",
    "ObjectDetectionV1",
    "FaceDetectionV1",
    "OcrTextV1",
    "PlacePrediction",
    "PlaceClassificationV1",
    "MetadataV1",
    "EmbeddingChunkV1",
    "SpeakerTurnV1",
]
