"""Projection synchronization: artifact envelopes -> denormalized query tables.

Copy of eioku_tpu/services/projection_sync.py for the PyTorch port.

Capability parity: backend/src/services/projection_sync_service.py:26-513:
routes each artifact type to its projection —
  transcript.segment -> transcript_fts (+meta)
  ocr.text           -> ocr_fts (+meta)
  scene              -> scene_ranges
  object.detection   -> object_labels
  face.detection     -> face_clusters
  video.metadata     -> video_locations (with reverse geocoding)
  embedding.chunk    -> embedding_chunks (new: semantic index slots)
place.classification has no projection (matching the reference, which comments it out).

Unlike the reference (which duplicated this service verbatim in backend and
ml-service), there is exactly one implementation here, shared by all processes.
Projections are rebuildable from the artifacts table via `resync_all`.
"""
from __future__ import annotations

import logging

from eioku_tpu_torch.db.connection import Database
from eioku_tpu_torch.domain.artifacts import ArtifactEnvelope, utcnow
from eioku_tpu_torch.repositories._util import dt_to_str
from eioku_tpu_torch.services.geocoding import OfflineReverseGeocoder, ReverseGeocoder

log = logging.getLogger(__name__)


class ProjectionSyncService:
    def __init__(self, db: Database, geocoder: ReverseGeocoder | None = None):
        self.db = db
        self.geocoder = geocoder or OfflineReverseGeocoder()

    def sync_artifact(self, env: ArtifactEnvelope) -> None:
        handler = {
            "transcript.segment": self._sync_transcript,
            "ocr.text": self._sync_ocr,
            "scene": self._sync_scene,
            "object.detection": self._sync_object,
            "face.detection": self._sync_face,
            "video.metadata": self._sync_metadata,
            "embedding.chunk": self._sync_embedding,
        }.get(env.artifact_type)
        if handler is not None:
            handler(env)

    # -- FTS ------------------------------------------------------------------

    def _sync_fts(self, env: ArtifactEnvelope, fts_table: str, meta_table: str,
                  text: str, language: str | None) -> None:
        with self.db.transaction() as conn:
            old = conn.execute(
                f"SELECT rowid FROM {meta_table} WHERE artifact_id=?",
                (env.artifact_id,)).fetchone()
            if old is not None:
                conn.execute(f"DELETE FROM {fts_table} WHERE rowid=?", (old[0],))
                conn.execute(f"DELETE FROM {meta_table} WHERE rowid=?", (old[0],))
            # content rowid keys the sidecar meta row; PG yields it via
            # RETURNING, while SQLite's fts5 virtual tables return -1 from
            # RETURNING (tested) so there it must come from lastrowid
            if self.db.dialect.name == "postgresql":
                rid = conn.execute(
                    f"INSERT INTO {fts_table} (text) VALUES (?) RETURNING rowid",
                    (text,)).fetchone()[0]
            else:
                rid = conn.execute(
                    f"INSERT INTO {fts_table} (text) VALUES (?)",
                    (text,)).lastrowid
            conn.execute(
                f"INSERT INTO {meta_table} (rowid, artifact_id, asset_id, start_ms,"
                " end_ms, language, run_id) VALUES (?,?,?,?,?,?,?)",
                (rid, env.artifact_id, env.asset_id, env.span_start_ms,
                 env.span_end_ms, language, env.run_id),
            )

    def _sync_transcript(self, env: ArtifactEnvelope) -> None:
        p = env.payload_json
        self._sync_fts(env, "transcript_fts", "transcript_fts_meta",
                       p.get("text", ""), p.get("language"))

    def _sync_ocr(self, env: ArtifactEnvelope) -> None:
        p = env.payload_json
        langs = p.get("languages") or []
        self._sync_fts(env, "ocr_fts", "ocr_fts_meta",
                       p.get("text", ""), langs[0] if langs else None)

    # -- navigation tables ------------------------------------------------------

    def _sync_scene(self, env: ArtifactEnvelope) -> None:
        p = env.payload_json
        self.db.execute(
            self.db.dialect.upsert(
                "scene_ranges", ["artifact_id", "asset_id", "scene_index",
                                 "start_ms", "end_ms", "run_id"],
                ["artifact_id"]),
            (env.artifact_id, env.asset_id, p["scene_index"], env.span_start_ms,
             env.span_end_ms, env.run_id),
        )

    def _sync_object(self, env: ArtifactEnvelope) -> None:
        p = env.payload_json
        self.db.execute(
            self.db.dialect.upsert(
                "object_labels", ["artifact_id", "asset_id", "label",
                                  "confidence", "start_ms", "end_ms", "run_id"],
                ["artifact_id"]),
            (env.artifact_id, env.asset_id, p["label"], p["confidence"],
             env.span_start_ms, env.span_end_ms, env.run_id),
        )

    def _sync_face(self, env: ArtifactEnvelope) -> None:
        p = env.payload_json
        self.db.execute(
            self.db.dialect.upsert(
                "face_clusters", ["artifact_id", "asset_id", "cluster_id",
                                  "confidence", "start_ms", "end_ms", "run_id"],
                ["artifact_id"]),
            (env.artifact_id, env.asset_id, p.get("cluster_id"), p["confidence"],
             env.span_start_ms, env.span_end_ms, env.run_id),
        )

    def _sync_metadata(self, env: ArtifactEnvelope) -> None:
        gps = env.payload_json.get("gps")
        if not gps:
            return
        lat, lon = gps.get("latitude"), gps.get("longitude")
        if lat is None or lon is None:
            return
        info = {"country": None, "state": None, "city": None}
        try:
            info = self.geocoder.get_location_info(lat, lon)
        except Exception:
            log.exception("reverse geocoding failed", extra={"asset_id": env.asset_id})
        self.db.execute(
            self.db.dialect.upsert(
                "video_locations", ["asset_id", "latitude", "longitude",
                                    "country", "state", "city", "updated_at"],
                ["asset_id"]),
            (env.asset_id, lat, lon, info.get("country"), info.get("state"),
             info.get("city"), dt_to_str(utcnow())),
        )

    def _sync_embedding(self, env: ArtifactEnvelope) -> None:
        p = env.payload_json
        # one transaction: a crash between the stale-slot delete and the
        # insert must not leave the artifact unindexed. The delete exists
        # because re-embedding can move an artifact to a new slot
        # (artifact_id is UNIQUE; the upsert only resolves slot conflicts)
        with self.db.transaction() as conn:
            conn.execute(
                "DELETE FROM embedding_chunks WHERE artifact_id=? AND slot<>?",
                (env.artifact_id, p["index_slot"]))
            conn.execute(
                self.db.dialect.upsert(
                    "embedding_chunks", ["slot", "artifact_id", "asset_id",
                                         "start_ms", "end_ms", "text",
                                         "source", "model", "run_id"],
                    ["slot"]),
                (p["index_slot"], env.artifact_id, env.asset_id,
                 env.span_start_ms, env.span_end_ms, p["text"], p["source"],
                 p["model"], env.run_id),
            )

    def delete_for_asset(self, asset_id: str) -> None:
        """Remove every projection row for an asset (video deletion cleanup);
        without this, FTS still returns hits for deleted videos."""
        with self.db.transaction() as conn:
            for fts, meta in (("transcript_fts", "transcript_fts_meta"),
                              ("ocr_fts", "ocr_fts_meta")):
                rows = conn.execute(
                    f"SELECT rowid FROM {meta} WHERE asset_id=?",
                    (asset_id,)).fetchall()
                for (rowid,) in rows:
                    conn.execute(f"DELETE FROM {fts} WHERE rowid=?", (rowid,))
                conn.execute(f"DELETE FROM {meta} WHERE asset_id=?", (asset_id,))
            for table in ("scene_ranges", "object_labels", "face_clusters",
                          "video_locations", "embedding_chunks", "topics",
                          "frame_embeddings"):
                conn.execute(f"DELETE FROM {table} WHERE asset_id=?", (asset_id,))

    # -- rebuild ----------------------------------------------------------------

    def resync_all(self) -> int:
        """Rebuild every projection from the artifacts table
        (reference: backend/src/commands/resync_projections.py:14-73)."""
        from eioku_tpu_torch.repositories.artifact_repository import _row_to_envelope

        with self.db.transaction() as conn:
            for table in ("transcript_fts", "transcript_fts_meta", "ocr_fts",
                          "ocr_fts_meta", "scene_ranges", "object_labels",
                          "face_clusters", "video_locations", "embedding_chunks"):
                conn.execute(f"DELETE FROM {table}")
        rows = self.db.query("SELECT * FROM artifacts ORDER BY created_at")
        n = 0
        for r in rows:
            try:
                self.sync_artifact(_row_to_envelope(r))
                n += 1
            except Exception:
                log.exception("resync failed", extra={"artifact_id": r["artifact_id"]})
        return n
