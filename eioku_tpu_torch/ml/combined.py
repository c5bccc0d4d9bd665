"""Combined visual analysis: one decode pass feeds scene scoring, object and
face detection, place classification and OCR (port of
eioku_tpu/ml/combined.py).

The video is decoded once at the finest sampling rate and frames are routed
to each consumer:

  - scene scoring takes every sampled frame (host resize to 96x160 -> I420
    upload -> device HSV -> scene-diff kernel), in fixed 256-slot chunks;
  - object detection takes the subset on its interval, accumulated into
    fixed-size batches and dispatched to the device asynchronously. Where
    places sample the same grid, the same I420 upload also feeds ResNet18
    (a device-side antialiased resize to 224); where the face grid is a
    multiple of the object grid, the face detector reads a device-side
    gather of that upload (the face rider);
  - otherwise faces have their own consumer and places their own batches
    (host resize to 224);
  - OCR takes the frames on its interval: one CRAFT pass per batch (host
    resize to 384x640, I420 upload) shared by every configured language,
    then box extraction on the host and one CRNN pass per recognizer group.

Results are returned per task type. Of the detection options the pass
reads `int8` (objects, faces and the face rider); like the JAX pass it
ignores `preprocess` and `data_parallel`.
"""
from __future__ import annotations

import os
import shutil

import cv2
import numpy as np
import torch
import torch.nn.functional as F

from eioku_tpu_torch.ml import video_io
from eioku_tpu_torch.ml.detection import (
    INPUT_SIZE,
    _assign_face_clusters,
    _load_model,
    attach_face_embeddings,
    emit_boxes,
    face_payload,
    fetch,
    letterbox_batch,
    object_payload,
)
from eioku_tpu_torch.ml.ocr_task import (
    DETECT_H,
    DETECT_W,
    craft_scores_i420,
    detect_text_crops,
    ocr_rows,
    recognize_crops,
)
from eioku_tpu_torch.ml.ocr_task import _models as ocr_models
from eioku_tpu_torch.ml.places import _model as load_places
from eioku_tpu_torch.ml.places import classify, place_records
from eioku_tpu_torch.ml.scenes import SCENE_H, SCENE_W, assemble_scenes, scene_rows
from eioku_tpu_torch.models.ocr.weights import recognizer_for_language
from eioku_tpu_torch.models.resnet.model import INPUT_SIZE as PLACE_SIZE
from eioku_tpu_torch.models.resnet.model import normalize
from eioku_tpu_torch.models.yolo.classes import COCO_CLASSES
from eioku_tpu_torch.models.yolo.postprocess import detect, pad_offsets_for
from eioku_tpu_torch.ops.colorspace import (
    i420_frames_to_hsv_planes,
    i420_to_rgb,
    to_i420,
)
from eioku_tpu_torch.ops.scene_diff import scene_scores
from eioku_tpu_torch.utils import progress
from eioku_tpu_torch.utils.device import resolve_device

SCENE_CHUNK = 256
MAX_PENDING_PLACES = 48  # standalone places batches dispatched, not fetched


def _detect_i420(model, planes: torch.Tensor, conf_threshold: float) -> dict:
    """Upload-lean detection: I420 planes in, the whole detect graph on the
    device. detect() keeps its default candidate pool (top_k 256): the
    combined pass, like the JAX package's, does not read
    object_detection.top_k (the standalone object_detection task does)."""
    return detect(model, i420_to_rgb(planes), conf_threshold=conf_threshold)


def resize_for_places(rgb: torch.Tensor) -> torch.Tensor:
    """Decode-scale RGB [B, H, W, 3] -> [B, 224, 224, 3], bilinear with
    antialiasing, as jax.image.resize(method="bilinear") does when it
    downsamples (without the antialias the pixels differ by up to 0.5)."""
    imgs = F.interpolate(rgb.permute(0, 3, 1, 2), size=(PLACE_SIZE, PLACE_SIZE),
                         mode="bilinear", align_corners=False, antialias=True)
    return imgs.permute(0, 2, 3, 1)


def _places_rgb(pmodel, rgb: torch.Tensor, top_k: int):
    """Places top-k from decode-scale RGB [B, H, W, 3] in [0, 1]."""
    return classify(pmodel, normalize(resize_for_places(rgb)), top_k)


def _places_i420(pmodel, planes: torch.Tensor, top_k: int):
    """Standalone places classification from host-resized 224px I420 thumbs."""
    return classify(pmodel, normalize(i420_to_rgb(planes)), top_k)


def _detect_faces_i420(ymodel, fmodel, planes: torch.Tensor,
                       face_idx: torch.Tensor, conf_threshold: float,
                       face_conf: float):
    """Objects + faces from one upload: the face grid is a subset of the
    object grid, so faces read a device-side gather of the same I420 upload
    instead of paying their own host-to-device transfer."""
    rgb = i420_to_rgb(planes)
    det = detect(ymodel, rgb, conf_threshold=conf_threshold)
    fdet = detect(fmodel, rgb[face_idx], conf_threshold=face_conf)
    return det, fdet


def _detect_places_faces_i420(ymodel, pmodel, fmodel, planes: torch.Tensor,
                              face_idx: torch.Tensor, conf_threshold: float,
                              top_k: int, face_conf: float):
    """The fully fused frame pass: one I420 upload feeds objects, places (a
    device-side resize) and the face-grid gather."""
    rgb = i420_to_rgb(planes)
    det = detect(ymodel, rgb, conf_threshold=conf_threshold)
    sc, idx = _places_rgb(pmodel, rgb, top_k)
    fdet = detect(fmodel, rgb[face_idx], conf_threshold=face_conf)
    return det, sc, idx, fdet


def _detect_places_i420(ymodel, pmodel, planes: torch.Tensor,
                        conf_threshold: float, top_k: int):
    """Objects + places from one upload: at the default 1 s cadence both
    sample the same frames, so the separate 224px host resize and upload
    disappear."""
    rgb = i420_to_rgb(planes)
    det = detect(ymodel, rgb, conf_threshold=conf_threshold)
    sc, idx = _places_rgb(pmodel, rgb, top_k)
    return det, sc, idx


class _DetectionConsumer:
    """Accumulates sampled frames into fixed batches for one detector.

    Offered frames may be pre-downscaled by the shared decode pass;
    coord_scale maps detector coordinates back to source pixels so payloads
    stay in original-frame coordinates.

    places = (model, labels, top_k): this consumer's frames also feed the
    places classifier in the same device program. face_rider = {"model",
    "conf", "step", "payload_builder"}: the face grid is a multiple of this
    consumer's grid, so face frames ride the same upload via a device-side
    gather; their rows go to face_rider["results"]."""

    # bounds queued device work: each undrained flush pins its uploaded batch
    MAX_PENDING = 16

    def __init__(self, model_name: str, num_classes: int, class_names,
                 conf: float, step: int, batch_size: int, cache_dir,
                 payload_builder, frame_ms: int, src_wh: tuple[int, int],
                 coord_scale: float, device: torch.device,
                 places: tuple | None = None, face_rider: dict | None = None,
                 int8: bool = False):
        self.model = _load_model(model_name, num_classes, cache_dir, device, int8)
        self.class_names = class_names
        self.device = device
        self.conf = conf
        self.step = max(step, 1)
        self.batch_size = batch_size
        self.payload_builder = payload_builder
        self.frame_ms = frame_ms
        self.src_wh = src_wh
        self.coord_scale = coord_scale
        self.places = places
        self.place_results: list[dict] = []
        self.face_rider = face_rider
        if face_rider is not None:
            face_rider.setdefault("results", [])
        self._frames: list[np.ndarray] = []
        self._meta: list[tuple[int, int]] = []  # (frame_idx, t_ms)
        self._pending: list[tuple] = []  # dispatched, not yet fetched
        self.results: list[dict] = []

    def offer(self, frame: np.ndarray, frame_idx: int, t_ms: int) -> None:
        if frame_idx % self.step != 0:
            return
        self._frames.append(frame)
        self._meta.append((frame_idx, t_ms))
        if len(self._frames) == self.batch_size:
            self.flush()

    def _upload_i420(self, frames) -> torch.Tensor:
        return torch.from_numpy(to_i420(list(frames))).to(self.device)

    def flush(self) -> None:
        """Dispatch the batch to the device without fetching its results:
        CUDA work is asynchronous, so detection overlaps decode and the other
        consumers; drain() fetches."""
        if not self._frames:
            return
        valid = len(self._frames)
        # bucket partial batches to the next power of two: a final 20-frame
        # flush uploads a 32-slot batch, not the full 64
        bucket = self.batch_size
        for c in (1, 2, 4, 8, 16, 32, 64, 128, 256):
            if valid <= c <= self.batch_size:
                bucket = c
                break
        stack = np.stack(self._frames + [np.zeros_like(self._frames[0])]
                         * (bucket - valid))
        h, w = stack.shape[1:3]
        if max(h, w) == INPUT_SIZE:
            # decode already delivered detector-scale frames: upload the
            # real pixels only and let detect() pad to stride alignment on
            # the device
            scale, pads = 1.0, pad_offsets_for(h, w)
            boxed = stack
        else:
            boxed, scale, pads = letterbox_batch(stack, valid)
        places_out = None
        face_out = None  # (fdet, face_meta, face_valid) when faces rode along
        even = boxed.shape[1] % 2 == 0 and boxed.shape[2] % 2 == 0
        letterboxed = boxed is not stack
        rider = self.face_rider
        face_sel = []
        if rider is not None:
            face_sel = [k for k, (fi, _) in enumerate(self._meta)
                        if fi % rider["step"] == 0]
        if even and not letterboxed and face_sel:
            # fully fused: one upload feeds objects (+ places) and the
            # face-grid gather; face_idx is padded to a per-bucket cap so the
            # gather's shape is fixed. The cap bounds the face frames a
            # bucket can hold: none is ever dropped.
            cap = bucket // max(rider["step"] // self.step, 1) + 1
            assert len(face_sel) <= cap, (len(face_sel), cap)
            fidx = np.zeros((cap,), np.int64)
            fidx[:len(face_sel)] = face_sel
            planes = self._upload_i420(boxed)
            face_idx = torch.from_numpy(fidx).to(self.device)
            if self.places is not None:
                pmodel, _, topk = self.places
                out, psc, pidx, fdet = _detect_places_faces_i420(
                    self.model, pmodel, rider["model"], planes, face_idx,
                    self.conf, topk, rider["conf"])
                places_out = (psc, pidx)
            else:
                out, fdet = _detect_faces_i420(
                    self.model, rider["model"], planes, face_idx, self.conf,
                    rider["conf"])
            face_out = (fdet, [self._meta[k] for k in face_sel], len(face_sel))
        elif even and self.places is not None and not letterboxed:
            # one upload for objects and places: the detector frames are the
            # raw decode output (no gray bars), so places can read them too
            pmodel, _, topk = self.places
            out, psc, pidx = _detect_places_i420(
                self.model, pmodel, self._upload_i420(boxed), self.conf, topk)
            places_out = (psc, pidx)
        else:
            if even:
                # ship I420 (half the bytes); the device converts back
                out = _detect_i420(self.model, self._upload_i420(boxed), self.conf)
            else:  # odd geometry can't subsample chroma: plain RGB upload
                out = detect(self.model, torch.from_numpy(boxed).to(self.device),
                             conf_threshold=self.conf)
            if self.places is not None:
                # letterboxed (or odd) frames would feed gray bars into the
                # classifier: resize the RAW frames to 224 on the host, as
                # the standalone path does
                resized = [cv2.resize(f, (PLACE_SIZE, PLACE_SIZE),
                                      interpolation=cv2.INTER_AREA)
                           for f in self._frames]
                resized += [np.zeros_like(resized[0])] * (bucket - valid)
                pmodel, _, topk = self.places
                places_out = _places_i420(pmodel, self._upload_i420(resized), topk)
        if face_sel and face_out is None:
            # the fused route did not run (letterbox or odd geometry): gather
            # the face frames on the host and run the rider's own detect
            fstack = np.stack([boxed[k] for k in face_sel])
            fdet = detect(rider["model"], torch.from_numpy(fstack).to(self.device),
                          conf_threshold=rider["conf"])
            face_out = (fdet, [self._meta[k] for k in face_sel], len(face_sel))
        self._pending.append((out, self._meta, scale, pads, valid, places_out,
                              face_out))
        self._frames, self._meta = [], []
        if len(self._pending) >= self.MAX_PENDING:
            self.drain()

    def drain(self) -> None:
        for out, meta, scale, pads, valid, places_out, face_out in self._pending:
            if places_out is not None:
                self.place_results.extend(place_records(
                    places_out[0].cpu().numpy(), places_out[1].cpu().numpy(),
                    meta, valid, self.places[1], self.frame_ms))
            if face_out is not None:
                fdet, fmeta, fvalid = face_out
                emit_boxes(self.face_rider["results"], fetch(fdet), fmeta, scale,
                           pads, fvalid, self.coord_scale, self.src_wh,
                           self.frame_ms, [], self.face_rider["payload_builder"])
            emit_boxes(self.results, fetch(out), meta, scale, pads, valid,
                       self.coord_scale, self.src_wh, self.frame_ms,
                       self.class_names, self.payload_builder)
        self._pending = []


class _OcrConsumer:
    """Accumulates sampled frames for the OCR path: one CRAFT detection pass
    per batch shared by every configured language, then one recognition pass
    per script-specific recognizer (languages mapping to the same recognizer
    share it)."""

    MAX_PENDING = 8  # grayscale staging for undrained CRAFT batches

    def __init__(self, cfg: dict, step: int, batch_size: int, cache_dir,
                 src_wh: tuple[int, int], frame_ms: int, device: torch.device):
        groups: dict[str, list[str]] = {}
        for lang in cfg.get("languages") or ["en"]:
            groups.setdefault(recognizer_for_language(lang), []).append(lang)
        self.recognizers = []
        for rec, langs in groups.items():
            craft, crnn, charset, _ = ocr_models(cache_dir, rec, device)
            self.craft = craft  # the same CRAFT weights for every group
            self.recognizers.append((crnn, charset, langs))
        self.device = device
        self.min_conf = float(cfg.get("confidence_threshold", 0.0))
        self.step = max(step, 1)
        self.batch_size = batch_size
        self.frame_ms = frame_ms
        self.src_w, self.src_h = src_wh
        self._frames: list[np.ndarray] = []
        self._meta: list[tuple[int, int]] = []
        self._pending: list[tuple] = []  # dispatched CRAFT, not yet fetched
        self.results: list[dict] = []

    def offer(self, frame: np.ndarray, frame_idx: int, t_ms: int) -> None:
        if frame_idx % self.step != 0:
            return
        self._frames.append(frame)
        self._meta.append((frame_idx, t_ms))
        if len(self._frames) == self.batch_size:
            self.flush()

    def flush(self) -> None:
        """Dispatch CRAFT asynchronously; quad extraction and recognition,
        which need the maps on the host, happen in drain()."""
        if not self._frames:
            return
        valid = len(self._frames)
        det = [cv2.resize(f, (DETECT_W, DETECT_H), interpolation=cv2.INTER_AREA)
               for f in self._frames]
        det += [np.zeros_like(det[0])] * (self.batch_size - valid)
        stack = np.stack(det)
        # I420 upload and normalisation on the device: 1.5 B/px, not 12
        scores = craft_scores_i420(self.craft,
                                   torch.from_numpy(to_i420(list(stack))).to(self.device))
        grays = [cv2.cvtColor(stack[i], cv2.COLOR_RGB2GRAY) for i in range(valid)]
        self._pending.append((scores, grays, self._meta))
        self._frames, self._meta = [], []
        if len(self._pending) >= self.MAX_PENDING:
            self.drain()

    def drain(self) -> None:
        sx = self.src_w / DETECT_W
        sy = self.src_h / DETECT_H
        for scores_dev, grays, meta in self._pending:
            scores = scores_dev.cpu().numpy()
            for i, gray in enumerate(grays):
                crops, metas = detect_text_crops(gray, scores[i, :, :, 0],
                                                 scores[i, :, :, 1])
                if not crops:
                    continue
                frame_idx, t_ms = meta[i]
                for crnn, charset, langs in self.recognizers:
                    self.results.extend(ocr_rows(
                        recognize_crops(crnn, crops, charset), metas, self.min_conf,
                        sx, sy, langs, frame_idx, t_ms, self.frame_ms))
        self._pending = []


def run_visual_analysis(video_path: str, config: dict,
                        model_cache_dir: str | None = None,
                        device: str | torch.device | None = None
                        ) -> dict[str, list[dict]]:
    """Returns {task_type: results} for scene_detection, object_detection,
    face_detection, place_classification and ocr (each present when its
    sub-config is) from ONE decode pass."""
    scfg = config.get("scene_detection")
    ocfg = config.get("object_detection")
    fcfg = config.get("face_detection")
    pcfg = config.get("place_classification")
    xcfg = config.get("ocr")
    dev = resolve_device(device)

    info = video_io.probe(video_path)
    fps = info.fps or 30.0
    frame_ms = int(round(1000.0 / fps))
    # base sampling grid: the scene cadence when scenes run, else the
    # fastest active consumer cadence
    if scfg is not None:
        interval_s = 1.0 / max(float(scfg.get("sample_fps", 4.0)), 1e-6)
    else:
        candidates = [float(c.get("frame_interval_s", d))
                      for c, d in ((ocfg, 1.0), (fcfg, 3.0), (pcfg, 1.0),
                                   (xcfg, 2.0)) if c is not None]
        interval_s = min(candidates) if candidates else 1.0
    base_step = max(int(round(fps * interval_s)), 1)

    def substep(seconds: float) -> int:
        # consumer steps are in source-frame units, aligned to the base grid
        return max(int(round(fps * seconds / base_step)), 1) * base_step

    # decode directly at the detector's long-side geometry (aspect
    # preserved): places and scenes derive from ~1/4 the source pixels and
    # detection letterboxing becomes pad-only; boxes map back via coord_scale
    det_long = int(config.get("detector_size", 640))
    ds = det_long / max(info.width, info.height, 1)
    if ds < 1.0:
        dec_hw = (max(int(round(info.height * ds)), 2) // 2 * 2,
                  max(int(round(info.width * ds)), 2) // 2 * 2)
        coord_scale = info.width / dec_hw[1]
    else:
        dec_hw = None
        coord_scale = 1.0
    src_wh = (info.width, info.height)

    if pcfg is not None:
        place_model, place_labels = load_places(model_cache_dir, dev)
        place_step = substep(float(pcfg.get("frame_interval_s", 1.0)))
        place_topk = int(pcfg.get("top_k", 5))
        place_bs = int(pcfg.get("batch_size", 64))
    else:
        place_step = 0
    obj_step = substep(float(ocfg.get("frame_interval_s", 1.0))) \
        if ocfg is not None else 0
    # places fuse into the object consumer when both sample the same grid
    # (the 1 s default): one I420 upload, one device program for both tasks
    fuse_places = pcfg is not None and ocfg is not None and place_step == obj_step
    face_step = substep(float(fcfg.get("frame_interval_s", 3.0))) \
        if fcfg is not None else 0
    face_conf = float(fcfg.get("confidence_threshold", 0.7)) \
        if fcfg is not None else 0.0
    # faces fuse into the object consumer when their (sparser) grid is a
    # multiple of the object grid: the face frames are a device-side gather
    # of the already-uploaded object batch
    fuse_faces = fcfg is not None and ocfg is not None \
        and face_step % max(obj_step, 1) == 0 \
        and bool(config.get("fuse_faces", True))
    face_rider = {
        "model": _load_model(fcfg.get("model", "yolov8n-face"), 1,
                             model_cache_dir, dev, bool(fcfg.get("int8", False))),
        "conf": face_conf, "step": face_step, "payload_builder": face_payload,
        "results": []} if fuse_faces else None
    objects = _DetectionConsumer(
        ocfg.get("model", "yolov8n"), len(COCO_CLASSES), COCO_CLASSES,
        float(ocfg.get("confidence_threshold", 0.5)), obj_step,
        int(ocfg.get("batch_size", 64)), model_cache_dir, object_payload,
        frame_ms, src_wh, coord_scale, dev,
        places=(place_model, place_labels, place_topk) if fuse_places else None,
        face_rider=face_rider, int8=bool(ocfg.get("int8", False))) \
        if ocfg is not None else None
    if fuse_places:
        place_step = 0  # the standalone places path below stays idle
    faces = _DetectionConsumer(
        fcfg.get("model", "yolov8n-face"), 1, [], face_conf, face_step,
        int(fcfg.get("batch_size", 64)), model_cache_dir, face_payload,
        frame_ms, src_wh, coord_scale, dev, int8=bool(fcfg.get("int8", False))) \
        if fcfg is not None and not fuse_faces else None
    ocr = _OcrConsumer(
        xcfg, substep(float(xcfg.get("frame_interval_s", 2.0))),
        int(xcfg.get("batch_size", 16)), model_cache_dir, src_wh, frame_ms,
        dev) if xcfg is not None else None

    place_batch: list[np.ndarray] = []
    place_meta: list[tuple[int, int]] = []
    place_pending: list[tuple] = []  # (scores_dev, idx_dev, meta, valid)
    place_results: list[dict] = []

    def flush_places():
        """Dispatch asynchronously; drain_places() fetches."""
        if not place_batch:
            return
        valid = len(place_batch)
        # host resize to 224 keeps the upload small; I420 halves it again
        resized = [cv2.resize(f, (PLACE_SIZE, PLACE_SIZE),
                              interpolation=cv2.INTER_AREA) for f in place_batch]
        stack = resized + [np.zeros_like(resized[0])] * (place_bs - valid)
        sc, idx = _places_i420(place_model,
                               torch.from_numpy(to_i420(stack)).to(dev),
                               place_topk)
        place_pending.append((sc, idx, list(place_meta), valid))
        place_batch.clear()
        place_meta.clear()
        if len(place_pending) >= MAX_PENDING_PLACES:
            drain_places()

    def drain_places():
        for sc, idx, meta, valid in place_pending:
            place_results.extend(place_records(
                sc.cpu().numpy(), idx.cpu().numpy(), meta, valid, place_labels,
                frame_ms))
        place_pending.clear()

    # scene state: sampled frames accumulate into fixed 256-slot chunks;
    # score tensors stay on the device until the post-pass and the
    # previous-plane carry is device-side
    threshold = float(scfg.get("threshold", 0.1)) if scfg is not None else 0.0
    prev_plane = torch.zeros((SCENE_H * SCENE_W * 3,), dtype=torch.float32,
                             device=dev)
    scene_buf: list[np.ndarray] = []  # 96x160 frames awaiting scoring
    scene_stamps: list[int] = []
    scene_pending: list[tuple] = []  # (scores_dev, timestamps, valid)

    def flush_scenes():
        nonlocal prev_plane
        if not scene_buf:
            return
        valid = len(scene_buf)
        stack = scene_buf + [np.zeros_like(scene_buf[0])] \
            * (SCENE_CHUNK - valid)
        planes = i420_frames_to_hsv_planes(
            torch.from_numpy(to_i420(stack)).to(dev))
        scene_pending.append((scene_scores(prev_plane, planes),
                              list(scene_stamps), valid))
        prev_plane = planes[valid - 1]
        scene_buf.clear()
        scene_stamps.clear()

    # keyframe cache: persist 1 s-grid frames as JPEGs so the downstream
    # visual-index task reads them instead of re-decoding the source
    kf_dir = config.get("keyframe_cache_dir")
    kf_step = 0
    if kf_dir:
        shutil.rmtree(kf_dir, ignore_errors=True)  # replace a stale cache
        os.makedirs(kf_dir, exist_ok=True)
        kf_step = substep(float(config.get("keyframe_cache_interval_s", 1.0)))

    for batch in video_io.prefetch(video_io.iter_frame_batches(
            video_path, batch_size=int(config.get("batch_size", 32)),
            frame_interval_s=interval_s, resize_hw=dec_hw,
            decode_threads=int(config.get("decode_threads", 4)),
            decode_procs=int(config.get("decode_procs", 0)),
            fast_level=int(config.get("decode_fast", 1)))):
        if kf_step:
            for i in range(batch.valid):
                if int(batch.frame_indices[i]) % kf_step == 0:
                    cv2.imwrite(
                        os.path.join(kf_dir,
                                     f"{int(batch.timestamps_ms[i])}.jpg"),
                        cv2.cvtColor(batch.frames[i], cv2.COLOR_RGB2BGR))
        if scfg is not None:
            # scene scoring needs only 96x160: resize on the host so the
            # upload is ~40x smaller than full-resolution frames
            for i in range(batch.valid):
                scene_buf.append(cv2.resize(batch.frames[i],
                                            (SCENE_W, SCENE_H),
                                            interpolation=cv2.INTER_AREA))
                scene_stamps.append(int(batch.timestamps_ms[i]))
                if len(scene_buf) == SCENE_CHUNK:
                    flush_scenes()
        for slot in range(batch.valid):
            fi = int(batch.frame_indices[slot])
            t_ms = int(batch.timestamps_ms[slot])
            # .copy(): a view would pin the whole decode batch in memory
            # until the consumer's next flush
            if objects is not None:
                objects.offer(batch.frames[slot].copy(), fi, t_ms)
            if faces is not None:
                faces.offer(batch.frames[slot].copy(), fi, t_ms)
            if ocr is not None:
                ocr.offer(batch.frames[slot].copy(), fi, t_ms)
            if place_step and fi % place_step == 0:
                place_batch.append(batch.frames[slot].copy())
                place_meta.append((fi, t_ms))
                if len(place_batch) == place_bs:
                    flush_places()
        if info.duration_ms > 0 and batch.valid:
            # the post-loop drain is a small tail; cap decode at 95%
            progress.report(0.95 * batch.timestamps_ms[batch.valid - 1]
                            / info.duration_ms)
    # final partial batches ALL dispatch before anything drains, so their
    # uploads and executions queue back to back
    if scfg is not None:
        flush_scenes()
    if objects is not None:
        objects.flush()
    if faces is not None:
        faces.flush()
    flush_places()
    if ocr is not None:
        ocr.flush()
    if objects is not None:
        objects.drain()
    if faces is not None:
        faces.drain()
    drain_places()
    if ocr is not None:
        ocr.drain()

    out: dict[str, list[dict]] = {}
    if scfg is not None:
        boundaries: list[tuple[int, float]] = []
        first = True
        for scores_dev, stamps, valid in scene_pending:
            scores = scores_dev.cpu().numpy()
            for slot in range(valid):
                if first and slot == 0:
                    first = False
                elif scores[slot] > threshold:
                    boundaries.append((int(stamps[slot]),
                                       float(scores[slot])))
        out["scene_detection"] = scene_rows(assemble_scenes(
            boundaries, info.duration_ms,
            float(scfg.get("min_scene_len_s", 0.5))))
    if objects is not None:
        out["object_detection"] = objects.results
    if fcfg is not None:
        face_results = face_rider["results"] if fuse_faces else faces.results
        _assign_face_clusters(face_results, frame_step=face_step)
        if fcfg.get("embeddings"):
            # the pass has released its frames: re-decode the face-sampled
            # ones on the TRUE face grid (face_step, snapped to the base step)
            attach_face_embeddings(video_path, face_results, face_step,
                                   model_cache_dir, dev)
        out["face_detection"] = face_results
    if pcfg is not None:
        out["place_classification"] = objects.place_results if fuse_places \
            else place_results
    if ocr is not None:
        out["ocr"] = ocr.results
    return out
