"""Core artifact domain objects.

Copy of eioku_tpu/domain/artifacts.py for the PyTorch port.

Capability parity with the reference's frozen artifact contract
(backend/src/domain/artifacts.py:7-182): every ML result is a
time-aligned, versioned *ArtifactEnvelope* carrying full provenance (producer,
model profile, config hash, input hash, run id) so any task can be re-run into a
new run and the "current" run chosen later by a SelectionPolicy.
"""
from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any

VALID_MODEL_PROFILES = ("fast", "balanced", "high_quality")

VALID_SELECTION_MODES = (
    "latest",
    "latest_per_language",
    "pinned",
    "profile",
    "best_quality",
)

# Preference order used by best_quality selection (reference:
# backend/src/repositories/artifact_repository.py:288-301).
PROFILE_QUALITY_ORDER = ("high_quality", "balanced", "fast")


def utcnow() -> datetime:
    return datetime.now(timezone.utc)


def new_id() -> str:
    return str(uuid.uuid4())


@dataclass(frozen=True)
class ArtifactEnvelope:
    """A single time-aligned ML result with provenance.

    ``span_start_ms``/``span_end_ms`` delimit the interval of the asset the result
    applies to; point-in-time results use a zero-length span. ``payload_json`` must
    validate against the (artifact_type, schema_version) entry in the SchemaRegistry.
    """

    artifact_id: str
    asset_id: str
    artifact_type: str
    schema_version: int
    span_start_ms: int
    span_end_ms: int
    payload_json: dict[str, Any]
    producer: str
    producer_version: str
    model_profile: str
    config_hash: str
    input_hash: str
    run_id: str
    created_at: datetime = field(default_factory=utcnow)

    def __post_init__(self) -> None:
        if not self.artifact_id:
            raise ValueError("artifact_id must be non-empty")
        if not self.asset_id:
            raise ValueError("asset_id must be non-empty")
        if not self.artifact_type:
            raise ValueError("artifact_type must be non-empty")
        if self.schema_version < 1:
            raise ValueError("schema_version must be >= 1")
        if self.span_start_ms < 0:
            raise ValueError("span_start_ms must be >= 0")
        if self.span_end_ms < self.span_start_ms:
            raise ValueError("span_end_ms must be >= span_start_ms")
        if self.model_profile not in VALID_MODEL_PROFILES:
            raise ValueError(
                f"model_profile must be one of {VALID_MODEL_PROFILES}, got {self.model_profile!r}"
            )
        if not isinstance(self.payload_json, dict):
            raise ValueError("payload_json must be a dict")

    def overlaps(self, start_ms: int, end_ms: int) -> bool:
        """True if this artifact's span intersects [start_ms, end_ms)."""
        return self.span_start_ms < end_ms and self.span_end_ms > start_ms

    def to_dict(self) -> dict[str, Any]:
        return {
            "artifact_id": self.artifact_id,
            "asset_id": self.asset_id,
            "artifact_type": self.artifact_type,
            "schema_version": self.schema_version,
            "span_start_ms": self.span_start_ms,
            "span_end_ms": self.span_end_ms,
            "payload_json": self.payload_json,
            "producer": self.producer,
            "producer_version": self.producer_version,
            "model_profile": self.model_profile,
            "config_hash": self.config_hash,
            "input_hash": self.input_hash,
            "run_id": self.run_id,
            "created_at": self.created_at.isoformat(),
        }


@dataclass(frozen=True)
class Run:
    """One execution of a task producing a coherent set of artifacts.

    Re-running a task always mints a new run; old artifacts are never mutated
    (reference: backend/src/domain/artifacts.py:76-129).
    """

    run_id: str
    asset_id: str
    task_type: str
    producer: str
    producer_version: str
    model_profile: str
    config_hash: str
    input_hash: str
    created_at: datetime = field(default_factory=utcnow)
    config_json: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.run_id:
            raise ValueError("run_id must be non-empty")
        if not self.asset_id:
            raise ValueError("asset_id must be non-empty")
        if self.model_profile not in VALID_MODEL_PROFILES:
            raise ValueError(
                f"model_profile must be one of {VALID_MODEL_PROFILES}, got {self.model_profile!r}"
            )


@dataclass(frozen=True)
class SelectionPolicy:
    """Decides which run's artifacts are "current" for an (asset, artifact_type).

    Modes (reference: backend/src/domain/artifacts.py:131-182,
    backend/src/repositories/artifact_repository.py:231-301):
      - latest: newest run wins.
      - latest_per_language: newest run per distinct payload language.
      - pinned: an explicit run_id.
      - profile: newest run with a given model_profile.
      - best_quality: prefer high_quality > balanced > fast, newest within tier.
    """

    mode: str = "latest"
    run_id: str | None = None
    model_profile: str | None = None

    def __post_init__(self) -> None:
        if self.mode not in VALID_SELECTION_MODES:
            raise ValueError(
                f"mode must be one of {VALID_SELECTION_MODES}, got {self.mode!r}"
            )
        if self.mode == "pinned" and not self.run_id:
            raise ValueError("pinned selection requires run_id")
        if self.mode == "profile":
            if self.model_profile not in VALID_MODEL_PROFILES:
                raise ValueError("profile selection requires a valid model_profile")

    @classmethod
    def default(cls) -> "SelectionPolicy":
        return cls(mode="latest")

    def to_dict(self) -> dict[str, Any]:
        return {"mode": self.mode, "run_id": self.run_id, "model_profile": self.model_profile}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SelectionPolicy":
        return cls(
            mode=d.get("mode", "latest"),
            run_id=d.get("run_id"),
            model_profile=d.get("model_profile"),
        )
