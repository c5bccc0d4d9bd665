"""Schema registry mapping (artifact_type, schema_version) -> pydantic model.

Copy of eioku_tpu/domain/schema_registry.py for the PyTorch port.

Capability parity: backend/src/domain/schema_registry.py:13-152 and
schema_initialization.py:16-56 (idempotent startup registration).
"""
from __future__ import annotations

from typing import Any, Type

from pydantic import BaseModel, ValidationError

from eioku_tpu_torch.domain.schemas import (
    EmbeddingChunkV1,
    FaceDetectionV1,
    MetadataV1,
    ObjectDetectionV1,
    OcrTextV1,
    PlaceClassificationV1,
    SceneV1,
    SpeakerTurnV1,
    TranscriptSegmentV1,
)


class SchemaValidationError(ValueError):
    pass


class SchemaRegistry:
    _schemas: dict[tuple[str, int], Type[BaseModel]] = {}

    @classmethod
    def register(cls, artifact_type: str, version: int, model: Type[BaseModel]) -> None:
        key = (artifact_type, version)
        existing = cls._schemas.get(key)
        if existing is not None and existing is not model:
            raise ValueError(f"conflicting registration for {key}: {existing} vs {model}")
        cls._schemas[key] = model

    @classmethod
    def get(cls, artifact_type: str, version: int) -> Type[BaseModel]:
        try:
            return cls._schemas[(artifact_type, version)]
        except KeyError:
            raise KeyError(f"no schema registered for ({artifact_type!r}, v{version})") from None

    @classmethod
    def is_registered(cls, artifact_type: str, version: int) -> bool:
        return (artifact_type, version) in cls._schemas

    @classmethod
    def registered_types(cls) -> list[tuple[str, int]]:
        return sorted(cls._schemas.keys())

    @classmethod
    def validate(cls, artifact_type: str, version: int, payload: dict[str, Any]) -> BaseModel:
        model = cls.get(artifact_type, version)
        try:
            return model.model_validate(payload)
        except ValidationError as e:
            raise SchemaValidationError(
                f"payload failed validation for ({artifact_type}, v{version}): {e}"
            ) from e

    @classmethod
    def serialize(cls, artifact_type: str, version: int, payload: BaseModel) -> dict[str, Any]:
        model = cls.get(artifact_type, version)
        if not isinstance(payload, model):
            raise SchemaValidationError(
                f"expected {model.__name__} for ({artifact_type}, v{version})"
            )
        return payload.model_dump(mode="json")

    @classmethod
    def clear(cls) -> None:
        """Test hook."""
        cls._schemas.clear()


ARTIFACT_SCHEMAS_V1 = {
    "transcript.segment": TranscriptSegmentV1,
    "scene": SceneV1,
    "object.detection": ObjectDetectionV1,
    "face.detection": FaceDetectionV1,
    "ocr.text": OcrTextV1,
    "place.classification": PlaceClassificationV1,
    "video.metadata": MetadataV1,
    "embedding.chunk": EmbeddingChunkV1,
    "speaker.turn": SpeakerTurnV1,
}


def register_all_schemas() -> None:
    """Idempotent registration of all v1 schemas; call at every process start."""
    for artifact_type, model in ARTIFACT_SCHEMAS_V1.items():
        SchemaRegistry.register(artifact_type, 1, model)
