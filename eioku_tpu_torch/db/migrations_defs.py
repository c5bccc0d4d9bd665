"""All schema migrations, in order.

Copy of eioku_tpu/db/migrations_defs.py for the PyTorch port.

Table inventory mirrors the reference's 23 alembic migrations condensed to their
final state (backend/src/database/models.py:7-146 and
alembic/versions/*): videos, path_configs, tasks, runs, artifacts,
artifact_selections, plus projection tables (transcript_fts, ocr_fts, scene_ranges,
object_labels, face_clusters, video_locations, topics) and the queue tables this
framework adds (the reference used Redis for its queue; this framework's queue is
sqlite-durable, see eioku_tpu/queue/).

All DDL is ANSI-portable across SQLite and PostgreSQL except the FTS
projections, which are dialect-built (SQLite FTS5 + porter stemming vs PG
tsvector + GIN — the reference's dual branches,
backend/alembic/versions/f8a2b3c4d5e6_...py:23-99); each
migration receives the database's dialect (eioku_tpu/db/dialect.py).
"""
from __future__ import annotations

from eioku_tpu_torch.db.connection import execute_script


def m0001_core_tables(conn, dialect) -> None:
    execute_script(conn, 
        """
        CREATE TABLE videos (
            id TEXT PRIMARY KEY,
            path TEXT NOT NULL UNIQUE,
            file_hash TEXT NOT NULL DEFAULT '',
            size_bytes INTEGER NOT NULL DEFAULT 0,
            duration_ms INTEGER,
            status TEXT NOT NULL DEFAULT 'discovered',
            created_at TEXT NOT NULL,
            file_created_at TEXT,
            processed_at TEXT
        );
        CREATE INDEX idx_videos_status ON videos(status);

        CREATE TABLE path_configs (
            id TEXT PRIMARY KEY,
            path TEXT NOT NULL UNIQUE,
            recursive INTEGER NOT NULL DEFAULT 1,
            enabled INTEGER NOT NULL DEFAULT 1,
            created_at TEXT NOT NULL
        );

        CREATE TABLE tasks (
            id TEXT PRIMARY KEY,
            video_id TEXT NOT NULL REFERENCES videos(id) ON DELETE CASCADE,
            task_type TEXT NOT NULL,
            status TEXT NOT NULL DEFAULT 'pending',
            priority INTEGER NOT NULL DEFAULT 5,
            language TEXT,
            config_json TEXT NOT NULL DEFAULT '{}',
            error TEXT,
            created_at TEXT NOT NULL,
            started_at TEXT,
            completed_at TEXT,
            attempts INTEGER NOT NULL DEFAULT 0
        );
        CREATE INDEX idx_tasks_video ON tasks(video_id);
        CREATE INDEX idx_tasks_status ON tasks(status);
        CREATE INDEX idx_tasks_type ON tasks(task_type);
        CREATE UNIQUE INDEX idx_tasks_unique
            ON tasks(video_id, task_type, COALESCE(language, ''));
        """
    )


def m0002_artifact_envelope(conn, dialect) -> None:
    execute_script(conn, 
        """
        CREATE TABLE runs (
            run_id TEXT PRIMARY KEY,
            asset_id TEXT NOT NULL,
            task_type TEXT NOT NULL,
            producer TEXT NOT NULL,
            producer_version TEXT NOT NULL,
            model_profile TEXT NOT NULL,
            config_hash TEXT NOT NULL,
            input_hash TEXT NOT NULL,
            created_at TEXT NOT NULL,
            config_json TEXT NOT NULL DEFAULT '{}'
        );
        CREATE INDEX idx_runs_asset ON runs(asset_id, task_type);

        CREATE TABLE artifacts (
            artifact_id TEXT PRIMARY KEY,
            asset_id TEXT NOT NULL,
            artifact_type TEXT NOT NULL,
            schema_version INTEGER NOT NULL,
            span_start_ms INTEGER NOT NULL,
            span_end_ms INTEGER NOT NULL,
            payload_json TEXT NOT NULL,
            producer TEXT NOT NULL,
            producer_version TEXT NOT NULL,
            model_profile TEXT NOT NULL,
            config_hash TEXT NOT NULL,
            input_hash TEXT NOT NULL,
            run_id TEXT NOT NULL,
            created_at TEXT NOT NULL
        );
        CREATE INDEX idx_artifacts_asset_type ON artifacts(asset_id, artifact_type);
        CREATE INDEX idx_artifacts_run ON artifacts(run_id);
        CREATE INDEX idx_artifacts_span
            ON artifacts(asset_id, artifact_type, span_start_ms, span_end_ms);

        CREATE TABLE artifact_selections (
            asset_id TEXT NOT NULL,
            artifact_type TEXT NOT NULL,
            mode TEXT NOT NULL,
            run_id TEXT,
            model_profile TEXT,
            updated_at TEXT NOT NULL,
            PRIMARY KEY (asset_id, artifact_type)
        );
        """
    )


def m0003_fts_projections(conn, dialect) -> None:
    """FTS projections are the schema's one dialect-divergent DDL: SQLite FTS5
    + porter stemming vs PG tsvector GENERATED column + GIN (reference's dual
    branches: alembic/versions/f8a2b3c4d5e6_...py:23-99). Both keep the same
    content-table + sidecar-meta topology joined on rowid."""
    execute_script(conn, dialect.fts_schema(
        "transcript_fts", "transcript_fts_meta", "idx_tfts_meta_asset"))
    execute_script(conn, dialect.fts_schema(
        "ocr_fts", "ocr_fts_meta", "idx_ofts_meta_asset"))


def m0004_nav_projections(conn, dialect) -> None:
    execute_script(conn, 
        """
        CREATE TABLE scene_ranges (
            artifact_id TEXT PRIMARY KEY,
            asset_id TEXT NOT NULL,
            scene_index INTEGER NOT NULL,
            start_ms INTEGER NOT NULL,
            end_ms INTEGER NOT NULL,
            run_id TEXT NOT NULL
        );
        CREATE INDEX idx_scene_ranges_asset ON scene_ranges(asset_id, start_ms);

        CREATE TABLE object_labels (
            artifact_id TEXT PRIMARY KEY,
            asset_id TEXT NOT NULL,
            label TEXT NOT NULL,
            confidence REAL NOT NULL,
            start_ms INTEGER NOT NULL,
            end_ms INTEGER NOT NULL,
            run_id TEXT NOT NULL
        );
        CREATE INDEX idx_object_labels_asset ON object_labels(asset_id, label, start_ms);

        CREATE TABLE face_clusters (
            artifact_id TEXT PRIMARY KEY,
            asset_id TEXT NOT NULL,
            cluster_id TEXT,
            confidence REAL NOT NULL,
            start_ms INTEGER NOT NULL,
            end_ms INTEGER NOT NULL,
            run_id TEXT NOT NULL
        );
        CREATE INDEX idx_face_clusters_asset ON face_clusters(asset_id, start_ms);

        CREATE TABLE video_locations (
            asset_id TEXT PRIMARY KEY,
            latitude REAL NOT NULL,
            longitude REAL NOT NULL,
            country TEXT,
            state TEXT,
            city TEXT,
            updated_at TEXT NOT NULL
        );

        CREATE TABLE topics (
            id TEXT PRIMARY KEY,
            asset_id TEXT NOT NULL,
            label TEXT NOT NULL,
            score REAL NOT NULL DEFAULT 0,
            created_at TEXT NOT NULL
        );
        CREATE INDEX idx_topics_asset ON topics(asset_id);
        """
    )


def m0005_job_queue(conn, dialect) -> None:
    execute_script(conn, 
        """
        CREATE TABLE jobs (
            job_id TEXT PRIMARY KEY,
            queue TEXT NOT NULL DEFAULT 'ml_jobs',
            function TEXT NOT NULL,
            args_json TEXT NOT NULL DEFAULT '[]',
            kwargs_json TEXT NOT NULL DEFAULT '{}',
            status TEXT NOT NULL DEFAULT 'queued',
            priority INTEGER NOT NULL DEFAULT 5,
            attempts INTEGER NOT NULL DEFAULT 0,
            max_tries INTEGER NOT NULL DEFAULT 1,
            timeout_s REAL NOT NULL DEFAULT 3600,
            enqueued_at TEXT NOT NULL,
            started_at TEXT,
            finished_at TEXT,
            lease_expires_at TEXT,
            worker_id TEXT,
            result_json TEXT,
            error TEXT,
            abort_requested INTEGER NOT NULL DEFAULT 0
        );
        CREATE INDEX idx_jobs_queue_status ON jobs(queue, status, priority, enqueued_at);
        """
    )


def m0006_semantic_index(conn, dialect) -> None:
    execute_script(conn, 
        """
        CREATE TABLE embedding_chunks (
            slot INTEGER PRIMARY KEY,
            artifact_id TEXT NOT NULL UNIQUE,
            asset_id TEXT NOT NULL,
            start_ms INTEGER NOT NULL,
            end_ms INTEGER NOT NULL,
            text TEXT NOT NULL,
            source TEXT NOT NULL,
            model TEXT NOT NULL,
            run_id TEXT NOT NULL
        );
        CREATE INDEX idx_embedding_chunks_asset ON embedding_chunks(asset_id);
        """
    )


def m0007_task_progress(conn, dialect) -> None:
    # Fractional completion reported live by the ML pipelines (the reference's
    # task rows expose only status + timestamps, database/models.py:35-48).
    # Identical syntax on both dialects.
    execute_script(conn, "ALTER TABLE tasks ADD COLUMN progress REAL;")


def m0008_visual_index(conn, dialect) -> None:
    # keyframe (CLIP) embedding slots: like embedding_chunks but keyed to a
    # frame timestamp instead of a text chunk (eioku_tpu/index/visual.py)
    execute_script(conn,
        """
        CREATE TABLE frame_embeddings (
            slot INTEGER PRIMARY KEY,
            asset_id TEXT NOT NULL,
            ts_ms INTEGER NOT NULL,
            scene_index INTEGER,
            model TEXT NOT NULL,
            run_id TEXT NOT NULL
        );
        CREATE INDEX idx_frame_embeddings_asset ON frame_embeddings(asset_id);
        """
    )


MIGRATIONS = [
    (1, "core_tables", m0001_core_tables),
    (2, "artifact_envelope", m0002_artifact_envelope),
    (3, "fts_projections", m0003_fts_projections),
    (4, "nav_projections", m0004_nav_projections),
    (5, "job_queue", m0005_job_queue),
    (6, "semantic_index", m0006_semantic_index),
    (7, "task_progress", m0007_task_progress),
    (8, "visual_index", m0008_visual_index),
]
