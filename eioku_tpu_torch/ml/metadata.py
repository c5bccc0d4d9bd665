"""Container metadata extraction: first-party MP4/MOV, MKV, and AVI parsers.

Copy of eioku_tpu/ml/metadata.py for the PyTorch port.

Capability parity: ml-service/src/services/metadata_extractor.py:13-221,
which shells out to exiftool for 16 composite fields (duration, geometry, codec,
creation date, GPS, camera make/model). exiftool does not exist in this
environment, so this module parses containers directly:

  - ISO BMFF (MP4/MOV): mvhd (duration, creation time), tkhd/stsd (geometry,
    codecs), stts (frame count -> fps), udta (C)xyz (ISO 6709 GPS) +
    (C)mak/(C)mod camera tags, and the iPhone-style meta/keys/ilst tree
    (com.apple.quicktime.make/model/creationdate/location.ISO6709).
  - Matroska (MKV/WebM): EBML walk — Info (TimecodeScale, Duration, DateUTC,
    MuxingApp/WritingApp), TrackEntry (CodecID, DefaultDuration -> fps),
    Video (PixelWidth/Height), Audio (SamplingFrequency, Channels).
  - AVI (RIFF): avih (geometry, frame timing), strh/strf per stream
    (video fourcc + fps, audio format/channels/rate).

cv2 probe remains the last-resort fallback. I/O-bound, stays on host
(SURVEY.md component table).
"""
from __future__ import annotations

import datetime as _dt
import logging
import os
import re
import struct

log = logging.getLogger(__name__)

_CONTAINER_BOXES = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"udta", b"edts"}
# seconds between 1904-01-01 (MP4 epoch) and 1970-01-01 (unix epoch)
_MP4_EPOCH_OFFSET = 2082844800


def _iter_boxes(data: bytes, start: int, end: int):
    pos = start
    while pos + 8 <= end:
        size, = struct.unpack(">I", data[pos:pos + 4])
        box_type = data[pos + 4:pos + 8]
        header = 8
        if size == 1:  # 64-bit size
            if pos + 16 > end:
                return
            size, = struct.unpack(">Q", data[pos + 8:pos + 16])
            header = 16
        elif size == 0:  # to end of file
            size = end - pos
        if size < header or pos + size > end:
            return
        yield box_type, pos + header, pos + size
        pos += size


def _walk(data: bytes, start: int, end: int, path: tuple = ()):
    for box_type, body_start, body_end in _iter_boxes(data, start, end):
        yield path + (box_type,), body_start, body_end
        if box_type in _CONTAINER_BOXES:
            yield from _walk(data, body_start, body_end, path + (box_type,))
        elif box_type == b"meta":
            # ISO BMFF writes meta as a FullBox (4 version/flags bytes, always
            # zero, before the children); QuickTime-brand files (real iPhone
            # .MOV) write a plain box whose first child starts immediately —
            # there the same 4 bytes are the child's size field, never zero.
            off = 4 if data[body_start:body_start + 4] == b"\x00\x00\x00\x00" else 0
            yield from _walk(data, body_start + off, body_end, path + (box_type,))


def _mp4_time(seconds_since_1904: int) -> str | None:
    unix = seconds_since_1904 - _MP4_EPOCH_OFFSET
    if unix <= 0:
        return None
    return _dt.datetime.fromtimestamp(unix, _dt.timezone.utc).isoformat()


def _parse_iso6709(s: str) -> dict | None:
    m = re.match(r"([+-]\d+(?:\.\d+)?)([+-]\d+(?:\.\d+)?)([+-]\d+(?:\.\d+)?)?", s)
    if not m:
        return None
    out = {"latitude": float(m.group(1)), "longitude": float(m.group(2))}
    if m.group(3):
        out["altitude"] = float(m.group(3))
    if not (-90 <= out["latitude"] <= 90 and -180 <= out["longitude"] <= 180):
        return None
    return out


def extract_metadata(path: str) -> dict:
    """Return a MetadataV1-shaped payload dict for a video file."""
    out: dict = {"container": os.path.splitext(path)[1].lstrip(".").lower() or None,
                 "extra": {}}
    try:
        with open(path, "rb") as f:
            magic = f.read(12)
            f.seek(0)
            if magic[:4] == b"\x1aE\xdf\xa3":
                _parse_mkv(f, os.path.getsize(path), out)
            elif magic[:4] == b"RIFF" and magic[8:12] == b"AVI ":
                _parse_avi(f.read(4 * 1024 * 1024), out)
            else:
                data = _read_top_level_boxes(f, os.path.getsize(path))
                _parse_mp4(data, out)
    except Exception:
        log.exception("container parse failed", extra={"path": path})
    if out.get("duration_ms") is None or out.get("width") is None:
        _cv2_fallback(path, out)
    if out.get("create_date") is None:
        mtime = os.path.getmtime(path)
        out["create_date"] = _dt.datetime.fromtimestamp(
            mtime, _dt.timezone.utc).isoformat()
        out["extra"]["create_date_source"] = "file_mtime"
    return out


def _read_top_level_boxes(f, filesize: int,
                          max_bytes: int = 256 * 1024 * 1024) -> bytes:
    """Collect every top-level box EXCEPT mdat by seeking through the file.

    Media payloads routinely dwarf any fixed read window (the common
    non-faststart layout puts a multi-GB mdat before the tail moov), so the
    only reliable way to reach moov is to skip mdat via its header size.
    Complete top-level boxes concatenate into a valid box stream for
    _parse_mp4/_walk.
    """
    import struct as _struct

    chunks: list[bytes] = []
    collected = 0
    pos = 0
    while pos + 8 <= filesize and collected < max_bytes:
        f.seek(pos)
        hdr = f.read(16)
        if len(hdr) < 8:
            break
        size, = _struct.unpack(">I", hdr[:4])
        box_type = hdr[4:8]
        hdr_len = 8
        if size == 1 and len(hdr) >= 16:  # 64-bit largesize
            size, = _struct.unpack(">Q", hdr[8:16])
            hdr_len = 16
        elif size == 0:  # box extends to EOF
            size = filesize - pos
        if size < hdr_len:
            break
        if box_type != b"mdat" and size <= max_bytes - collected:
            f.seek(pos)
            chunk = f.read(min(size, filesize - pos))
            chunks.append(chunk)
            collected += len(chunk)
        pos += size
    return b"".join(chunks)


def _parse_mp4(data: bytes, out: dict) -> None:
    # Box order inside mdia is unspecified (mdhd usually precedes hdlr), so
    # collect per-track state first and resolve handler types afterwards.
    tracks: list[dict] = []
    current: dict | None = None
    for path, s, e in _walk(data, 0, len(data)):
        box = path[-1]
        body = data[s:e]
        if box == b"trak":
            current = {}
            tracks.append(current)
            continue
        if box == b"mvhd" and len(body) >= 20:
            version = body[0]
            if version == 1:
                ctime, _, tscale, dur = struct.unpack(">QQIQ", body[4:32])
            else:
                ctime, _, tscale, dur = struct.unpack(">IIII", body[4:20])
            if tscale:
                out["duration_ms"] = int(dur / tscale * 1000)
            out["create_date"] = _mp4_time(ctime)
        elif box == b"\xa9xyz" and len(body) >= 4:
            str_len, = struct.unpack(">H", body[0:2])
            gps = _parse_iso6709(body[4:4 + str_len].decode("latin-1", "replace"))
            if gps:
                out["gps"] = gps
        elif box in (b"\xa9mak", b"\xa9mod", b"\xa9day") and len(body) >= 4:
            # udta international-text box: 16-bit length + 16-bit language
            str_len, = struct.unpack(">H", body[0:2])
            text = body[4:4 + str_len].decode("utf-8", "replace").strip("\x00")
            if text:
                key = {b"\xa9mak": "camera_make", b"\xa9mod": "camera_model",
                       b"\xa9day": "create_date"}[box]
                # not setdefault: mvhd may already have stored create_date=None
                # (encoders that omit ctime write 0) and the tag should win
                if out.get(key) is None:
                    out[key] = text
        elif box == b"keys":
            _meta_keys = _parse_keys_box(body)
            out["extra"]["_meta_keys"] = _meta_keys
        elif box == b"ilst":
            _apply_ilst(body, out)
        elif current is not None and b"trak" in path:
            # the trak guard matters: a moov-level meta box (iPhone layout)
            # carries its OWN hdlr child (b"mdta"), which must not clobber
            # the last track's handler and wipe its video/audio attribution
            if box == b"tkhd" and len(body) >= 84:
                version = body[0]
                off = 88 if version == 1 else 76
                if len(body) >= off + 8:
                    w, h = struct.unpack(">II", body[off:off + 8])
                    current["width"], current["height"] = w >> 16, h >> 16
            elif box == b"hdlr" and len(body) >= 12:
                current["handler"] = body[8:12]
            elif box == b"mdhd" and len(body) >= 20:
                version = body[0]
                if version == 1:
                    _, _, tscale, dur = struct.unpack(">QQIQ", body[4:32])
                else:
                    _, _, tscale, dur = struct.unpack(">IIII", body[4:20])
                current["timescale"], current["duration_units"] = tscale, dur
            elif box == b"stsd" and len(body) >= 16:
                current["format"] = body[12:16].decode("latin-1")
                current["stsd_body"] = body[:64]
            elif box == b"stts" and len(body) >= 8:
                n_entries, = struct.unpack(">I", body[4:8])
                total = 0
                for i in range(min(n_entries, 10000)):
                    off = 8 + i * 8
                    if off + 8 > len(body):
                        break
                    count, _delta = struct.unpack(">II", body[off:off + 8])
                    total += count
                current["sample_count"] = total

    for t in tracks:
        handler = t.get("handler")
        if handler == b"vide":
            if t.get("width") and out.get("width") is None:
                out["width"], out["height"] = t["width"], t["height"]
            if out.get("codec") is None and t.get("format"):
                out["codec"] = t["format"]
            fc, ts, du = t.get("sample_count"), t.get("timescale"), t.get(
                "duration_units")
            if fc:
                out["extra"]["frame_count"] = fc
            if fc and ts and du and du > 0:
                out["fps"] = round(fc / (du / ts), 3)
        elif handler == b"soun":
            if t.get("format"):
                out["audio_codec"] = t["format"]
            body = t.get("stsd_body", b"")
            # sample entry: 16 stsd hdr + 8 reserved + 2 ch + 2 bits + 4 + 4 rate16.16
            if len(body) >= 16 + 28:
                ch, = struct.unpack(">H", body[16 + 16:16 + 18])
                rate, = struct.unpack(">I", body[16 + 24:16 + 28])
                out["audio_channels"] = ch
                out["audio_sample_rate"] = rate >> 16
    out["extra"].pop("_meta_keys", None)  # internal keys<->ilst plumbing


def _parse_keys_box(body: bytes) -> list[str]:
    """QuickTime metadata `keys` box -> ordered key names (1-indexed)."""
    if len(body) < 8:
        return []
    count, = struct.unpack(">I", body[4:8])
    keys: list[str] = []
    pos = 8
    for _ in range(min(count, 256)):
        if pos + 8 > len(body):
            break
        size, = struct.unpack(">I", body[pos:pos + 4])
        if size < 8 or pos + size > len(body):
            break
        keys.append(body[pos + 8:pos + size].decode("utf-8", "replace"))
        pos += size
    return keys


_QT_KEY_MAP = {
    "com.apple.quicktime.make": "camera_make",
    "com.apple.quicktime.model": "camera_model",
    "com.apple.quicktime.creationdate": "create_date",
    "com.apple.quicktime.software": None,  # -> extra
}


def _apply_ilst(body: bytes, out: dict) -> None:
    """QuickTime `ilst` values (index-typed children holding `data` boxes),
    resolved against the sibling `keys` box (iPhone/QuickTime layout)."""
    keys = out["extra"].get("_meta_keys") or []
    for box_type, s, e in _iter_boxes(body, 0, len(body)):
        idx = struct.unpack(">I", box_type)[0]
        if not 1 <= idx <= len(keys):
            continue
        key = keys[idx - 1]
        for inner, ds, de in _iter_boxes(body, s, e):
            if inner != b"data" or de - ds < 8:
                continue
            value = body[ds + 8:de].decode("utf-8", "replace").strip("\x00")
            if not value:
                continue
            if key == "com.apple.quicktime.location.ISO6709":
                gps = _parse_iso6709(value)
                if gps:
                    out.setdefault("gps", gps)
            elif key in _QT_KEY_MAP:
                field = _QT_KEY_MAP[key]
                if field:
                    out[field] = value
                else:
                    out["extra"][key.rsplit(".", 1)[-1]] = value


# -- Matroska (EBML) -------------------------------------------------------------

_MKV_EPOCH_OFFSET = 978307200  # 2001-01-01T00:00:00Z in unix seconds


def _ebml_vint_raw(f, keep_marker: bool) -> tuple[int, int] | None:
    """Shared vint reader: returns (value, length_bytes) or None at EOF."""
    first = f.read(1)
    if not first:
        return None
    b0 = first[0]
    if b0 == 0:
        return None
    length = 8 - b0.bit_length() + 1
    rest = f.read(length - 1)
    if len(rest) != length - 1:
        return None
    val = b0 if keep_marker else b0 & ((1 << (8 - length)) - 1)
    for byte in rest:
        val = (val << 8) | byte
    return val, length


def _ebml_vint(f, keep_marker: bool) -> int | None:
    out = _ebml_vint_raw(f, keep_marker)
    return None if out is None else out[0]


_EBML_UNKNOWN = -1


def _ebml_size(f) -> int | None:
    """Size vint; all data bits set at ANY vint length (0xFF, 0x7FFF, ...,
    the 8-byte form) is the spec's unknown-size marker, not a literal size —
    live-recorded MKVs use the short forms on Segment/Cluster."""
    out = _ebml_vint_raw(f, keep_marker=False)
    if out is None:
        return None
    val, length = out
    if val == (1 << (7 * length)) - 1:
        return _EBML_UNKNOWN
    return val


def _ebml_uint(data: bytes) -> int:
    v = 0
    for b in data:
        v = (v << 8) | b
    return v


def _ebml_float(data: bytes) -> float | None:
    if len(data) == 4:
        return struct.unpack(">f", data)[0]
    if len(data) == 8:
        return struct.unpack(">d", data)[0]
    return None


def _parse_mkv(f, filesize: int, out: dict) -> None:
    """Minimal EBML walk over Segment > Info/Tracks (clusters skipped by
    size, so multi-GB files cost a few seeks)."""
    # Segment > Info/Tracks(+TrackEntry/Video/Audio) + Tags>Tag>SimpleTag
    DESCEND = {0x18538067, 0x1549A966, 0x1654AE6B, 0xAE, 0xE0, 0xE1,
               0x1254C367, 0x7373, 0x67C8}

    timecode_scale = 1_000_000  # ns, Matroska default
    duration_units: float | None = None
    track: dict | None = None
    stags: list[dict] = []  # SimpleTag stack (SimpleTags can nest)

    def walk(end: int, depth: int):
        nonlocal timecode_scale, duration_units, track
        while f.tell() < end and depth < 8:
            eid = _ebml_vint(f, keep_marker=True)
            if eid is None:
                return
            size = _ebml_size(f)
            if size is None:
                return
            if size == _EBML_UNKNOWN or f.tell() + size > end:
                size = end - f.tell()  # unknown-size element: runs to end
            body_end = f.tell() + size
            if eid in DESCEND:
                if eid == 0xAE:
                    track = {}
                if eid == 0x67C8:
                    stags.append({})
                walk(body_end, depth + 1)
                if eid == 0xAE and track is not None:
                    _mkv_apply_track(track, out)
                    track = None
                if eid == 0x67C8 and stags:
                    _mkv_apply_simpletag(stags.pop(), out)
            elif size <= 4096:
                data = f.read(size)
                if eid == 0x2AD7B1:
                    timecode_scale = _ebml_uint(data) or timecode_scale
                elif eid == 0x4489:
                    duration_units = _ebml_float(data)
                elif eid == 0x4461:
                    ns = int.from_bytes(data, "big", signed=True)
                    out["create_date"] = _dt.datetime.fromtimestamp(
                        ns / 1e9 + _MKV_EPOCH_OFFSET,
                        _dt.timezone.utc).isoformat()
                elif eid == 0x4D80:
                    out["extra"]["muxing_app"] = data.decode("utf-8", "replace")
                elif eid == 0x5741:
                    out["extra"]["writing_app"] = data.decode("utf-8", "replace")
                elif stags and eid == 0x45A3:  # TagName
                    stags[-1]["name"] = data.decode("utf-8", "replace")
                elif stags and eid == 0x4487:  # TagString
                    stags[-1]["string"] = data.decode("utf-8", "replace")
                elif track is not None:
                    if eid == 0x83:
                        track["type"] = _ebml_uint(data)
                    elif eid == 0x86:
                        track["codec"] = data.decode("utf-8", "replace")
                    elif eid == 0x23E383:
                        track["frame_ns"] = _ebml_uint(data)
                    elif eid == 0xB0:
                        track["width"] = _ebml_uint(data)
                    elif eid == 0xBA:
                        track["height"] = _ebml_uint(data)
                    elif eid == 0xB5:
                        track["sample_rate"] = _ebml_float(data)
                    elif eid == 0x9F:
                        track["channels"] = _ebml_uint(data)
            f.seek(body_end)

    walk(filesize, 0)
    if duration_units is not None and duration_units > 0:
        out["duration_ms"] = int(duration_units * timecode_scale / 1e6)


_MKV_CODEC_NAMES = {
    "V_MPEG4/ISO/AVC": "h264", "V_MPEGH/ISO/HEVC": "hevc", "V_VP9": "vp9",
    "V_VP8": "vp8", "V_AV1": "av1", "A_AAC": "aac", "A_OPUS": "opus",
    "A_VORBIS": "vorbis", "A_MPEG/L3": "mp3", "A_FLAC": "flac",
}


def _mkv_apply_simpletag(st: dict, out: dict) -> None:
    """Map a Tags>Tag>SimpleTag (TagName/TagString) onto payload fields.
    Phones and muxers writing Matroska put camera identity here as
    MAKE/MODEL tags (ffmpeg -metadata make=... model=... emits the same);
    DATE_RECORDED is the Matroska-standard recording date tag."""
    name = (st.get("name") or "").strip().upper()
    val = (st.get("string") or "").strip()
    if not name or not val:
        return
    if name == "MAKE" and out.get("camera_make") is None:
        out["camera_make"] = val
    elif name == "MODEL" and out.get("camera_model") is None:
        out["camera_model"] = val
    elif name in ("DATE_RECORDED", "CREATION_TIME") and \
            out.get("create_date") is None:
        out["create_date"] = val
    elif name == "ENCODER":
        out["extra"].setdefault("writing_app", val)
    elif name == "TITLE":
        out["extra"].setdefault("title", val)


def _mkv_apply_track(track: dict, out: dict) -> None:
    codec = track.get("codec")
    name = _MKV_CODEC_NAMES.get(codec, codec)
    if track.get("type") == 1:  # video
        if track.get("width") and out.get("width") is None:
            out["width"], out["height"] = track["width"], track.get("height")
        if name and out.get("codec") is None:
            out["codec"] = name
        if track.get("frame_ns") and out.get("fps") is None:
            out["fps"] = round(1e9 / track["frame_ns"], 3)
    elif track.get("type") == 2:  # audio
        if name and out.get("audio_codec") is None:
            out["audio_codec"] = name
        if track.get("channels"):
            out.setdefault("audio_channels", track["channels"])
        if track.get("sample_rate"):
            out.setdefault("audio_sample_rate", int(track["sample_rate"]))


# -- AVI (RIFF) -----------------------------------------------------------------


def _parse_riff_date(text: str) -> str | None:
    """RIFF date text -> ISO string. ICRD is ISO-ish ('2008-08-18' or full
    datetime); IDIT is ctime-style ('MON AUG 18 10:00:00 2008', case varies
    by camera firmware)."""
    text = text.strip()
    if not text:
        return None
    try:
        return _dt.datetime.fromisoformat(text[:19]).isoformat()
    except ValueError:
        pass
    try:
        return _dt.datetime.strptime(text.title()[:24],
                                     "%a %b %d %H:%M:%S %Y").isoformat()
    except ValueError:
        return None


# INFO LIST text chunks (the slots exiftool reads from camera AVIs; RIFF has
# no standard make/model slot — camera identity lands in ISFT as the firmware
# name, surfaced as writing_app)
_AVI_INFO_TEXT = {b"ISFT": ("extra", "writing_app"),
                  b"INAM": ("extra", "title"),
                  b"IART": ("extra", "artist"),
                  b"ICMT": ("extra", "comment")}


def _parse_avi(data: bytes, out: dict) -> None:
    """RIFF walk: avih (geometry/timing), per-stream strh/strf, INFO text
    chunks (ISFT/INAM/IART/ICMT) and creation dates (ICRD, and IDIT — which
    camera firmwares put inside the hdrl LIST, so it is handled wherever it
    appears)."""
    if len(data) < 12:
        return
    micro_per_frame = total_frames = odml_frames = None
    stream_type = None

    def walk(start: int, end: int, depth: int):
        nonlocal micro_per_frame, total_frames, odml_frames, stream_type
        pos = start
        while pos + 8 <= end and depth < 6:
            fourcc = data[pos:pos + 4]
            size, = struct.unpack("<I", data[pos + 4:pos + 8])
            body = pos + 8
            if body + size > end:
                size = max(end - body, 0)
            if fourcc == b"LIST" and size >= 4:
                walk(body + 4, body + size, depth + 1)
            elif fourcc == b"avih" and size >= 40:
                micro_per_frame, = struct.unpack("<I", data[body:body + 4])
                total_frames, = struct.unpack("<I", data[body + 16:body + 20])
                w, h = struct.unpack("<II", data[body + 32:body + 40])
                if w and out.get("width") is None:
                    out["width"], out["height"] = w, h
            elif fourcc == b"dmlh" and size >= 4:
                # OpenDML extended header: total frames across ALL RIFF
                # segments — a >1 GB camcorder AVI's avih counts only the
                # first segment, so this value wins when present
                odml_frames, = struct.unpack("<I", data[body:body + 4])
            elif fourcc == b"strh" and size >= 28:
                stream_type = data[body:body + 4]
                scale, rate = struct.unpack("<II", data[body + 20:body + 28])
                if stream_type == b"vids" and scale and rate and \
                        out.get("fps") is None:
                    out["fps"] = round(rate / scale, 3)
            elif fourcc == b"strf":
                if stream_type == b"vids" and size >= 20 and \
                        out.get("codec") is None:
                    comp = data[body + 16:body + 20]
                    if comp.strip(b"\x00"):
                        out["codec"] = comp.decode("latin-1").strip().lower()
                elif stream_type == b"auds" and size >= 8:
                    tag, ch = struct.unpack("<HH", data[body:body + 4])
                    sample_rate, = struct.unpack("<I", data[body + 4:body + 8])
                    out.setdefault("audio_channels", ch)
                    out.setdefault("audio_sample_rate", sample_rate)
                    if out.get("audio_codec") is None:
                        out["audio_codec"] = {0x0001: "pcm", 0x0055: "mp3",
                                              0x00FF: "aac",
                                              0x2000: "ac3"}.get(tag, hex(tag))
            elif fourcc in _AVI_INFO_TEXT and size:
                text = data[body:body + size].split(b"\x00")[0] \
                    .decode("latin-1", "replace").strip()
                if text:
                    _, key = _AVI_INFO_TEXT[fourcc]
                    out["extra"].setdefault(key, text)
            elif fourcc in (b"ICRD", b"IDIT") and size:
                text = data[body:body + size].split(b"\x00")[0] \
                    .decode("latin-1", "replace")
                iso = _parse_riff_date(text)
                if iso and out.get("create_date") is None:
                    out["create_date"] = iso
            pos = body + size + (size & 1)  # chunks are word-aligned

    walk(12, len(data), 0)
    if odml_frames and (total_frames is None or odml_frames > total_frames):
        total_frames = odml_frames
    if micro_per_frame and total_frames and out.get("duration_ms") is None:
        out["duration_ms"] = int(micro_per_frame * total_frames / 1000)
        out["extra"].setdefault("frame_count", total_frames)


def _cv2_fallback(path: str, out: dict) -> None:
    try:
        from eioku_tpu_torch.ml.video_io import probe
        info = probe(path)
        out.setdefault("width", info.width or None)
        out.setdefault("height", info.height or None)
        if out.get("fps") is None and info.fps:
            out["fps"] = round(info.fps, 3)
        if out.get("duration_ms") is None and info.duration_ms:
            out["duration_ms"] = info.duration_ms
        out["extra"].setdefault("frame_count", info.frame_count)
    except Exception:
        log.warning("cv2 metadata fallback failed", extra={"path": path})
