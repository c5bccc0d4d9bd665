"""Subtitle export: transcript.segment artifacts -> WebVTT / SRT.

Copy of eioku_tpu/services/subtitles.py for the PyTorch port.

Beyond the reference (its transcripts live only in the DB/UI): standard
subtitle files make the library's transcripts portable to any player, and the
SPA attaches the VTT as a native <track> so captions render in the built-in
player. Segments arrive as envelope dicts (the /artifacts read path, same
selection policy as the Transcript tab, speaker labels optionally joined).
"""
from __future__ import annotations


def _ts(ms: int, sep: str) -> str:
    ms = max(int(ms), 0)
    h, rem = divmod(ms, 3_600_000)
    m, rem = divmod(rem, 60_000)
    s, milli = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}{sep}{milli:03d}"


def _sanitize(text: str, vtt: bool) -> str:
    """Make arbitrary ASR/imported text safe inside a cue: newlines collapse
    (an embedded blank line would terminate the cue), a literal '-->' would
    parse as a timing line, and in VTT '&'/'<' start entities/cue tags."""
    text = " ".join(text.split())
    text = text.replace("-->", "→")
    if vtt:
        text = text.replace("&", "&amp;").replace("<", "&lt;")
    return text


def _cues(segments: list[dict], vtt: bool) -> list[tuple[int, int, str]]:
    """(start_ms, end_ms, text) per segment; zero-length spans get a minimum
    1 s display window; empty texts are dropped. Speaker labels (joined by
    the read path) prefix the text the way players expect."""
    cues = []
    for seg in segments:
        p = seg.get("payload_json") or {}
        text = _sanitize((p.get("text") or ""), vtt).strip()
        if not text:
            continue
        speaker = p.get("speaker")
        if speaker:
            text = f"{_sanitize(str(speaker), vtt)}: {text}"
        start = int(seg.get("span_start_ms") or 0)
        end = int(seg.get("span_end_ms") or 0)
        if end <= start:
            end = start + 1000
        cues.append((start, end, text))
    cues.sort(key=lambda c: c[0])
    return cues


def to_vtt(segments: list[dict]) -> str:
    lines = ["WEBVTT", ""]
    for i, (start, end, text) in enumerate(_cues(segments, vtt=True), 1):
        lines += [str(i), f"{_ts(start, '.')} --> {_ts(end, '.')}", text, ""]
    return "\n".join(lines)


def to_srt(segments: list[dict]) -> str:
    lines = []
    for i, (start, end, text) in enumerate(_cues(segments, vtt=False), 1):
        lines += [str(i), f"{_ts(start, ',')} --> {_ts(end, ',')}", text, ""]
    return "\n".join(lines)
