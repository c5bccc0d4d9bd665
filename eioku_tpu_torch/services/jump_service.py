"""Jump navigation: next/previous artifact of a kind from a timestamp.

Copy of eioku_tpu/services/jump_service.py for the PyTorch port.

Capability parity: backend/src/services/jump_navigation_service.py:31-240
(kind -> artifact_type mapping, next = first span_start >= from_ms, prev = last
span_end < from_ms, filters label / cluster_id / min_confidence, selection policy).

Performance: the reference loads ALL artifacts of a type and filters in Python
(its own noted O(N)-per-jump issue). Here the filters run in SQL with indexes on
(asset_id, artifact_type, span_start_ms), restricted to the selected run.
"""
from __future__ import annotations

from typing import Any

from eioku_tpu_torch.domain.artifacts import SelectionPolicy
from eioku_tpu_torch.repositories.artifact_repository import ArtifactRepository
from eioku_tpu_torch.repositories.selection_policy_manager import SelectionPolicyManager

# kind -> artifact_type (reference: api/artifact_controller.py:96-115)
KIND_TO_ARTIFACT_TYPE = {
    "object": "object.detection",
    "face": "face.detection",
    "scene": "scene",
    "transcript": "transcript.segment",
    "ocr": "ocr.text",
    "place": "place.classification",
    "speaker": "speaker.turn",
}


class JumpNavigationService:
    def __init__(self, artifacts: ArtifactRepository, policies: SelectionPolicyManager):
        self.artifacts = artifacts
        self.policies = policies

    def jump(self, asset_id: str, kind: str, from_ms: int, direction: str = "next",
             label: str | None = None, cluster_id: str | None = None,
             min_confidence: float | None = None,
             selection: SelectionPolicy | None = None) -> dict[str, Any] | None:
        artifact_type = KIND_TO_ARTIFACT_TYPE.get(kind, kind)
        policy = selection or self.policies.get_policy(asset_id, artifact_type)
        payload_filters: dict[str, Any] = {}
        place_label = None
        if label is not None:
            if artifact_type == "place.classification":
                # place payloads nest labels under predictions[]; the SQL
                # json_extract('$.label') filter can't see them — match the
                # top prediction in Python (same rule jump_options counts by)
                place_label = label
            else:
                payload_filters["label"] = label
        if cluster_id is not None:
            payload_filters["cluster_id"] = cluster_id

        envs = self.artifacts.get_by_asset(
            asset_id, artifact_type=artifact_type, selection=policy,
            payload_filters=payload_filters or None,
        )
        if place_label is not None:
            envs = [e for e in envs
                    if (e.payload_json.get("predictions") or [{}])[0]
                    .get("label") == place_label]
        if min_confidence is not None:
            envs = [e for e in envs
                    if (e.payload_json.get("confidence") or 0.0) >= min_confidence
                    or self._max_prediction_conf(e) >= min_confidence]
        if direction == "next":
            candidates = [e for e in envs if e.span_start_ms >= from_ms]
            target = candidates[0] if candidates else None
        else:
            candidates = [e for e in envs if e.span_end_ms < from_ms]
            target = candidates[-1] if candidates else None
        if target is None:
            return None
        return {
            "artifact_id": target.artifact_id,
            "artifact_type": target.artifact_type,
            "start_ms": target.span_start_ms,
            "end_ms": target.span_end_ms,
            "payload": target.payload_json,
            "run_id": target.run_id,
        }

    def jump_options(self, asset_id: str) -> dict[str, Any]:
        """Aggregated jump targets for the UI: per-kind counts, object labels
        with counts, face clusters with counts, place labels with counts.

        Capability parity: the reference's JumpNavigationControl discovers
        artifact types and builds per-label/cluster/scene options client-side
        (frontend/src/components/JumpNavigationControl.tsx:23-140);
        here the aggregation is served so the SPA does one request."""
        # per-kind aggregation happens IN SQL (GROUP BY over json_extract):
        # a long video has thousands of detections, and deserializing every
        # envelope just to count labels cost hundreds of ms per video open
        agg_path = {"object": "$.label", "face": "$.cluster_id",
                    "place": "$.predictions[0].label", "speaker": "$.label"}
        present = set(self.artifacts.list_types_for_asset(asset_id))
        kinds: list[dict[str, Any]] = []
        for kind, atype in KIND_TO_ARTIFACT_TYPE.items():
            if atype not in present:
                continue
            policy = self.policies.get_policy(asset_id, atype)
            pairs, total = self.artifacts.count_payload_values(
                asset_id, atype, agg_path.get(kind, "$.label"), policy)
            if not total:
                continue
            entry: dict[str, Any] = {"kind": kind, "count": total}
            vals = [(v, n) for v, n in pairs if v is not None and v != ""]
            if kind in ("object", "place"):
                entry["labels"] = [{"label": v, "count": n} for v, n in vals]
            elif kind == "face":
                entry["clusters"] = [{"cluster_id": v, "count": n}
                                     for v, n in vals]
            elif kind == "speaker":
                # speaker.turn payloads carry the cluster name under "label"
                # (SpeakerTurnV1) so the generic label filter works for jumps
                entry["speakers"] = [{"speaker": v, "count": n}
                                     for v, n in vals]
            kinds.append(entry)
        return {"kinds": kinds}

    @staticmethod
    def _max_prediction_conf(env) -> float:
        preds = env.payload_json.get("predictions")
        if isinstance(preds, list) and preds:
            return max((p.get("confidence") or 0.0) for p in preds)
        return 0.0
