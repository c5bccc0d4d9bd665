"""Speaker diarization: who-spoke-when turns from audio (port of
eioku_tpu/ml/diarize.py).

  host: load audio -> energy VAD -> overlapping 1.5 s windows (hop 0.75 s)
  device: ECAPA-TDNN embeddings in batches of 32 windows, the last padded
  host: average-linkage clustering over cosine distance (scipy), labels
        renumbered by first appearance -> consecutive same-speaker windows
        merged into turns across gaps <= max_gap_ms, ends clamped to the
        audio's duration

The host stages are the JAX package's. The activation type is the config's
`compute_dtype`, by default bf16 on the card and fp32 on the CPU (the port's
rule, utils/device.compute_dtype; the JAX package defaults to bf16
everywhere). Results are payload dicts of the speaker.turn schema with
span_start_ms / span_end_ms.
"""
from __future__ import annotations

import logging
from functools import lru_cache

import numpy as np
import torch

from eioku_tpu_torch.ml import audio_io
from eioku_tpu_torch.models.speaker.model import EcapaConfig, ecapa_embed, load_ecapa
from eioku_tpu_torch.utils import progress
from eioku_tpu_torch.utils.device import compute_dtype_name, resolve_device

log = logging.getLogger(__name__)

SAMPLE_RATE = audio_io.SAMPLE_RATE


def slice_windows(audio: np.ndarray, window_s: float = 1.5,
                  hop_s: float = 0.75, vad: bool = True
                  ) -> list[tuple[int, np.ndarray]]:
    """Overlapping fixed-length windows [(start_ms, samples)], keeping only
    windows with voice activity (diarization embeds speech, not silence)."""
    win = int(SAMPLE_RATE * window_s)
    hop = int(SAMPLE_RATE * hop_s)
    if len(audio) < win:
        if len(audio) == 0:
            return []
        audio = np.pad(audio, (0, win - len(audio)))
    activity = audio_io.energy_vad(audio) if vad else None
    out: list[tuple[int, np.ndarray]] = []
    for start in range(0, len(audio) - win + 1, hop):
        if activity is not None and \
                not audio_io.window_is_active(activity, start, start + win):
            continue
        out.append((int(start / SAMPLE_RATE * 1000), audio[start:start + win]))
    return out


def embed_windows(model, windows: list[tuple[int, np.ndarray]],
                  batch_size: int = 32) -> np.ndarray:
    """All windows' embeddings [N, embed_dim] fp32, in batches of
    `batch_size` on the model's device; the last batch is padded with
    zeros, so every batch has one shape."""
    dev = next(model.parameters()).device
    embs: list[np.ndarray] = []
    for i in range(0, len(windows), batch_size):
        chunk = [w for _, w in windows[i:i + batch_size]]
        valid = len(chunk)
        chunk += [np.zeros_like(chunk[0])] * (batch_size - valid)
        batch = torch.from_numpy(np.stack(chunk).astype(np.float32)).to(dev)
        embs.append(ecapa_embed(model, batch)[:valid].cpu().numpy())
        progress.report((i + valid) / len(windows))
    return np.concatenate(embs, axis=0) if embs else np.zeros((0, 1), np.float32)


def cluster_embeddings(embs: np.ndarray, distance_threshold: float = 0.45,
                       max_speakers: int | None = None) -> np.ndarray:
    """Agglomerative average-linkage clustering over cosine distance.
    Returns int labels [N] ordered by first appearance (0 = first speaker)."""
    n = len(embs)
    if n == 0:
        return np.zeros(0, np.int32)
    if n == 1:
        return np.zeros(1, np.int32)
    from scipy.cluster.hierarchy import fcluster, linkage

    z = linkage(embs, method="average", metric="cosine")
    raw = fcluster(z, t=distance_threshold, criterion="distance")
    if max_speakers is not None and raw.max() > max_speakers:
        raw = fcluster(z, t=max_speakers, criterion="maxclust")
    # relabel by first appearance for stable SPEAKER_00.. naming
    order: dict[int, int] = {}
    labels = np.empty(n, np.int32)
    for i, r in enumerate(raw):
        if r not in order:
            order[r] = len(order)
        labels[i] = order[r]
    return labels


def windows_to_turns(windows: list[tuple[int, np.ndarray]], labels: np.ndarray,
                     embs: np.ndarray, window_s: float = 1.5,
                     max_gap_ms: int = 1000,
                     duration_ms: int | None = None) -> list[dict]:
    """Merge consecutive same-speaker windows into turns. Confidence is the
    mean cosine similarity of the turn's windows to their cluster centroid.
    Turn ends clamp to duration_ms (short audio is zero-padded to the window
    length, which would otherwise put span_end_ms past the real media)."""
    if not windows:
        return []
    win_ms = int(window_s * 1000)
    centroids: dict[int, np.ndarray] = {}
    for lab in np.unique(labels):
        c = embs[labels == lab].mean(axis=0)
        centroids[int(lab)] = c / max(float(np.linalg.norm(c)), 1e-10)
    turns: list[dict] = []
    cur: dict | None = None
    sims: list[float] = []

    def close(t, s):
        t["confidence"] = round(float(np.clip(np.mean(s), 0.0, 1.0)), 4)
        turns.append(t)

    for (start_ms, _), lab, emb in zip(windows, labels, embs):
        lab = int(lab)
        end_ms = start_ms + win_ms
        sim = float(np.dot(emb, centroids[lab]))
        if cur is not None and cur["_lab"] == lab \
                and start_ms - cur["end_ms"] <= max_gap_ms:
            cur["end_ms"] = max(cur["end_ms"], end_ms)
            sims.append(sim)
            continue
        if cur is not None:
            close(cur, sims)
        cur = {"label": f"SPEAKER_{lab:02d}", "start_ms": start_ms,
               "end_ms": end_ms, "_lab": lab}
        sims = [sim]
    if cur is not None:
        close(cur, sims)
    for t in turns:
        del t["_lab"]
        if duration_ms is not None:
            t["end_ms"] = min(t["end_ms"], max(duration_ms, t["start_ms"]))
    return turns


@lru_cache(maxsize=2)
def _load_model(model_cache_dir: str | None, cfg: EcapaConfig, device: torch.device):
    """The model per (cache dir, config, device): a library scan re-enters
    this once per task."""
    return load_ecapa(model_cache_dir, cfg, device=device)


def run_diarization(video_path: str, config: dict,
                    model_cache_dir: str | None = None,
                    device: str | torch.device | None = None) -> list[dict]:
    dev = resolve_device(device)
    audio_path = audio_io.find_audio_for_video(video_path)
    if audio_path is None:
        log.warning("no audio stream available for %s; emitting no speaker "
                    "turns", video_path)
        return []
    audio = audio_io.load_audio(audio_path)
    if len(audio) == 0:
        return []

    window_s = float(config.get("window_s", 1.5))
    hop_s = float(config.get("hop_s", 0.75))
    windows = slice_windows(audio, window_s=window_s, hop_s=hop_s,
                            vad=bool(config.get("vad_filter", True)))
    if not windows:
        return []

    default = EcapaConfig()
    cfg = EcapaConfig(
        channels=int(config.get("channels", default.channels)),
        res2net_scale=int(config.get("res2net_scale", default.res2net_scale)),
        se_channels=int(config.get("se_channels", default.se_channels)),
        attention_channels=int(config.get("attention_channels",
                                          default.attention_channels)),
        mfa_channels=int(config.get("mfa_channels", default.mfa_channels)),
        embed_dim=int(config.get("embed_dim", default.embed_dim)),
        compute_dtype=str(config.get("compute_dtype", compute_dtype_name(dev))))
    model = _load_model(model_cache_dir, cfg, dev)
    embs = embed_windows(model, windows, batch_size=int(config.get("batch_size", 32)))
    labels = cluster_embeddings(
        embs,
        distance_threshold=float(config.get("distance_threshold", 0.45)),
        max_speakers=(int(config["max_speakers"])
                      if config.get("max_speakers") else None))
    turns = windows_to_turns(windows, labels, embs, window_s=window_s,
                             max_gap_ms=int(config.get("max_gap_ms", 1000)),
                             duration_ms=int(len(audio) / SAMPLE_RATE * 1000))
    log.info("diarization: %d windows -> %d speakers, %d turns",
             len(windows), len(set(int(x) for x in labels)), len(turns))
    return [
        {"payload": t, "span_start_ms": t["start_ms"], "span_end_ms": t["end_ms"]}
        for t in turns
    ]
