"""Video discovery: scan configured paths, register videos, fan out tasks.

Copy of eioku_tpu/services/discovery.py for the PyTorch port.

Capability parity: backend/src/services/video_discovery_service.py:21-443:
scan paths for .mp4/.mov/.avi/.mkv (case-insensitive, optional recursion), dedupe
by path, hash files, create Video rows, create one task per active task type with
per-language fan-out (ocr: one per configured language; transcription: one per
language or a single auto-detect task), enqueue each, and validate/remove videos
whose files have gone missing (video_discovery_service.py:151-174).
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

from eioku_tpu_torch.config.settings import AppConfig
from eioku_tpu_torch.domain.models import Task, TaskStatus, Video, VideoStatus
from eioku_tpu_torch.domain.task_registry import (
    ACTIVE_TASK_TYPES,
    TASK_REGISTRY,
    is_language_optional,
    is_language_required,
)
from eioku_tpu_torch.queue.producer import JobProducer
from eioku_tpu_torch.repositories.path_config_repository import PathConfigRepository
from eioku_tpu_torch.repositories.task_repository import TaskRepository
from eioku_tpu_torch.repositories.video_repository import VideoRepository
from eioku_tpu_torch.utils.hashing import hash_file

log = logging.getLogger(__name__)

VIDEO_EXTENSIONS = {".mp4", ".mov", ".avi", ".mkv"}


@dataclass
class DiscoveryReport:
    videos_found: int = 0
    videos_new: int = 0
    videos_removed: int = 0
    tasks_created: int = 0
    tasks_enqueued: int = 0
    errors: list[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return self.__dict__.copy()


class VideoDiscoveryService:
    def __init__(self, config: AppConfig, videos: VideoRepository, tasks: TaskRepository,
                 paths: PathConfigRepository, producer: JobProducer | None,
                 artifacts=None, projection_sync=None):
        self.config = config
        self.videos = videos
        self.tasks = tasks
        self.paths = paths
        self.producer = producer
        self.artifacts = artifacts
        self.projection_sync = projection_sync

    # -- scanning ---------------------------------------------------------------

    def scan_path(self, root: str, recursive: bool = True) -> list[str]:
        root = os.path.expanduser(root)
        if not os.path.isdir(root):
            return []
        found: list[str] = []
        if recursive:
            for dirpath, _dirnames, filenames in os.walk(root):
                for name in filenames:
                    if os.path.splitext(name)[1].lower() in VIDEO_EXTENSIONS:
                        found.append(os.path.join(dirpath, name))
        else:
            for name in os.listdir(root):
                full = os.path.join(root, name)
                if os.path.isfile(full) and \
                        os.path.splitext(name)[1].lower() in VIDEO_EXTENSIONS:
                    found.append(full)
        return sorted(found)

    def discover(self, enqueue: bool = True) -> DiscoveryReport:
        """Scan all enabled configured paths; create videos + tasks; enqueue."""
        report = DiscoveryReport()
        seen: set[str] = set()
        for pc in self.paths.list(enabled_only=True):
            for path in self.scan_path(pc.path, pc.recursive):
                real = os.path.realpath(path)
                if real in seen:
                    continue
                seen.add(real)
                report.videos_found += 1
                try:
                    video, created = self._ensure_video(path)
                    if created:
                        report.videos_new += 1
                    c, e = self.create_and_enqueue_tasks(video, enqueue=enqueue)
                    report.tasks_created += c
                    report.tasks_enqueued += e
                except Exception as exc:
                    # Per-video error isolation (reference: main_api.py:168-173).
                    log.exception("discovery failed for video", extra={"path": path})
                    report.errors.append(f"{path}: {exc}")
        return report

    def _ensure_video(self, path: str) -> tuple[Video, bool]:
        existing = self.videos.get_by_path(path)
        if existing is not None:
            return existing, False
        video = Video(
            path=path,
            file_hash=hash_file(path),
            size_bytes=os.path.getsize(path),
            status=VideoStatus.DISCOVERED,
        )
        self.videos.save(video)
        return video, True

    # -- task fan-out -------------------------------------------------------------

    def _task_specs_for_video(self) -> list[tuple[str, str | None]]:
        """(task_type, language) pairs, with per-language fan-out
        (reference: video_discovery_service.py:176-275)."""
        active = tuple(self.config.active_task_types or ACTIVE_TASK_TYPES)
        if getattr(self.config, "combined_visual", False):
            # OCR folds in too: its frames come from the same decode pass,
            # with all configured languages sharing one CRAFT detection
            visual = {"scene_detection", "object_detection", "face_detection",
                      "place_classification", "ocr"}
            if visual & set(active):
                active = tuple(t for t in active if t not in visual) + (
                    "visual_analysis",)
        specs: list[tuple[str, str | None]] = []
        for task_type in active:
            if task_type not in TASK_REGISTRY:
                log.warning("skipping unknown task type", extra={"task_type": task_type})
                continue
            settings = self.config.settings_for(task_type)
            if is_language_required(task_type):
                for lang in settings.get("languages") or ["en"]:
                    specs.append((task_type, lang))
            elif is_language_optional(task_type):
                langs = settings.get("languages") or []
                if langs:
                    specs.extend((task_type, lang) for lang in langs)
                else:
                    specs.append((task_type, None))  # auto-detect
            else:
                specs.append((task_type, None))
        return specs

    def create_and_enqueue_tasks(self, video: Video,
                                 enqueue: bool = True) -> tuple[int, int]:
        created = enqueued = 0
        for task_type, language in self._task_specs_for_video():
            if self.tasks.exists(video.id, task_type, language):
                continue
            if task_type == "visual_analysis":
                # carries one sub-config per ACTIVE visual consumer
                # (ml/combined.py runs exactly the sub-tasks whose config is
                # present — an OCR-only fold must not run detection), plus
                # top-level fold settings (decode batch/threads/fast level)
                # from task_settings["visual_analysis"]
                active = set(self.config.active_task_types or ACTIVE_TASK_TYPES)
                config = dict(self.config.settings_for("visual_analysis"))
                config.update({sub: self.config.settings_for(sub)
                               for sub in ("scene_detection",
                                           "object_detection",
                                           "face_detection",
                                           "place_classification", "ocr")
                               if sub in active})
            else:
                config = self.config.settings_for(task_type)
            if language is not None:
                config = {**config, "language": language}
            task = Task(
                video_id=video.id, task_type=task_type, language=language,
                config=config,
                priority=self.config.priority_for(
                    task_type, TASK_REGISTRY[task_type].default_priority),
            )
            self.tasks.save(task)
            created += 1
            if enqueue and self.producer is not None:
                if self.producer.enqueue_task(task.id, task_type, video.id,
                                              video.path, config,
                                              priority=task.priority) is not None:
                    enqueued += 1
        return created, enqueued

    # -- validation -----------------------------------------------------------------

    def validate_existing(self) -> DiscoveryReport:
        """Mark/remove videos whose files no longer exist
        (reference: api/path_controller_full.py:103-151)."""
        report = DiscoveryReport()
        for video in self.videos.list(limit=100000):
            if not os.path.exists(video.path):
                for task in self.tasks.find(video_id=video.id, limit=1000):
                    if task.status in (TaskStatus.PENDING, TaskStatus.RUNNING):
                        if self.producer is not None:
                            self.producer.abort_task(task.id)
                # full cleanup like DELETE /videos/{id}: artifacts and
                # projections too, or search/find keep returning hits whose
                # video 404s
                self.tasks.delete_for_video(video.id)
                if self.artifacts is not None:
                    self.artifacts.delete_for_asset(video.id)
                if self.projection_sync is not None:
                    self.projection_sync.delete_for_asset(video.id)
                self.videos.delete(video.id)
                report.videos_removed += 1
        return report


async def discovery_loop(discovery: "VideoDiscoveryService",
                         interval_s: float,
                         stop: "asyncio.Event | None" = None) -> None:
    """Opt-in periodic re-scan (config discover_interval_s): files dropped
    into a watched folder are discovered and their tasks enqueued without a
    manual POST /paths/discover. Runs the blocking scan (directory walk +
    xxhash) off the event loop; the startup discovery already covered t=0, so
    the loop sleeps first."""
    import asyncio

    from eioku_tpu_torch.services.reconciler import periodic_loop

    async def scan():
        report = await asyncio.to_thread(discovery.discover)
        if report.videos_new or report.videos_removed:
            log.info("periodic discovery", extra=report.to_dict())

    await periodic_loop(scan, interval_s, stop or asyncio.Event(),
                        "periodic discovery", sleep_first=True)
