"""Host-side audio loading and voice activity for transcription (the port's
copy of what eioku_tpu/ml/audio_io.py's transcription path uses).

Sources: the native/audio_decode.cpp shim over the system FFmpeg libraries,
built by the port's own utils/native_build.py, decodes any container's audio
stream to 16 kHz mono float32; without it, .wav files load through the
stdlib (resampled to 16 kHz) and .mp3/.ogg/.flac through SDL_mixer (pygame)
with SDL's dummy audio output. For a video path a sidecar audio file with the
same basename is used when present; otherwise the task reports no audio.
The shim's encoders (`native_encode`, `native_media_encode`: `cli
extract-audio`) and its stream-copy clip remux (services/clips.py) are the
JAX package's too.

Voice activity: the model VAD (models/vad) when a Silero checkpoint under
the model cache loads, as in the JAX package; the energy VAD otherwise.
"""
from __future__ import annotations

import logging
import os
import wave

import numpy as np
import torch

from eioku_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

SAMPLE_RATE = 16000
AUDIO_EXTENSIONS = (".wav", ".mp3", ".ogg", ".flac", ".m4a", ".aac")
VAD_CHECKPOINT_NAME = "silero_vad.ckpt"  # models/vad/weights.py


def load_wav(path: str, target_sr: int = SAMPLE_RATE) -> np.ndarray:
    """Load a wav file -> float32 mono [-1, 1] at target_sr.

    Stdlib `wave` handles PCM; IEEE-float wavs (format tag 3) go through
    scipy.io.wavfile instead."""
    try:
        with wave.open(path, "rb") as w:
            sr = w.getframerate()
            n_ch = w.getnchannels()
            width = w.getsampwidth()
            raw = w.readframes(w.getnframes())
    except wave.Error:
        from scipy.io import wavfile
        sr, data = wavfile.read(path)
        if data.dtype == np.int16:
            x = data.astype(np.float32) / 32768.0
        elif data.dtype == np.int32:
            x = data.astype(np.float32) / 2147483648.0
        elif data.dtype == np.uint8:
            x = (data.astype(np.float32) - 128.0) / 128.0
        else:  # float32/float64
            x = data.astype(np.float32)
        n_ch = x.shape[1] if x.ndim > 1 else 1
    else:
        if width == 2:
            x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
        elif width == 4:
            x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
        elif width == 1:
            x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported wav sample width: {width}")
    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    if sr != target_sr:
        from math import gcd

        from scipy.signal import resample_poly
        g = gcd(sr, target_sr)
        x = resample_poly(x, target_sr // g, sr // g).astype(np.float32)
    return x


def _configure_av(lib) -> None:
    import ctypes
    lib.eioku_audio_decode.restype = ctypes.c_int
    lib.eioku_audio_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_longlong)]
    lib.eioku_audio_free.restype = None
    lib.eioku_audio_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.eioku_audio_probe.restype = ctypes.c_int
    lib.eioku_audio_probe.argtypes = [ctypes.c_char_p]
    lib.eioku_audio_encode.restype = ctypes.c_int
    lib.eioku_audio_encode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
        ctypes.c_int]
    lib.eioku_media_encode.restype = ctypes.c_int
    lib.eioku_media_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.POINTER(ctypes.c_float),
        ctypes.c_longlong, ctypes.c_int, ctypes.c_char_p]
    lib.eioku_media_encode_mapped.restype = ctypes.c_int
    lib.eioku_media_encode_mapped.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_float), ctypes.c_longlong, ctypes.c_int,
        ctypes.c_char_p]
    lib.eioku_media_encode_ex.restype = ctypes.c_int
    lib.eioku_media_encode_ex.argtypes = \
        lib.eioku_media_encode_mapped.argtypes + [ctypes.c_longlong,
                                                  ctypes.c_char_p]
    lib.eioku_clip_remux.restype = ctypes.c_int
    lib.eioku_clip_remux.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_longlong,
        ctypes.c_longlong]


def native_decoder():
    """The native/audio_decode.cpp shim, or None when it can't build/link."""
    from eioku_tpu_torch.utils.native_build import load_native_lib
    return load_native_lib(
        "audio_decode", _configure_av,
        link_libs=("avformat", "avcodec", "swresample", "swscale", "avutil"))


def native_decode(path: str, target_sr: int = SAMPLE_RATE) -> np.ndarray | None:
    """Decode any container's audio stream via the native shim. None when the
    shim is unavailable or the file has no audio stream; raises on a failed
    decode of a stream that exists."""
    import ctypes
    lib = native_decoder()
    if lib is None:
        return None
    buf = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_longlong()
    ret = lib.eioku_audio_decode(path.encode(), target_sr,
                                 ctypes.byref(buf), ctypes.byref(n))
    if ret == 1:  # container opened fine but carries no audio stream
        return None
    if ret != 0:
        raise RuntimeError(f"native audio decode failed for {path!r} "
                           f"(averror {ret})")
    try:
        x = np.ctypeslib.as_array(buf, shape=(n.value,)).copy()
    finally:
        lib.eioku_audio_free(buf)
    # float decode of hot lossy sources can slightly overshoot full scale
    return np.clip(x, -1.0, 1.0)


def native_encode(path: str, samples: np.ndarray,
                  sr: int = SAMPLE_RATE) -> None:
    """Encode mono float32 PCM as AAC into .m4a/.mp4/.mov at `path`."""
    import ctypes
    lib = native_decoder()
    if lib is None:
        raise RuntimeError("native audio shim unavailable")
    x = np.ascontiguousarray(samples, np.float32)
    ret = lib.eioku_audio_encode(
        path.encode(), x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(x), sr)
    if ret != 0:
        raise RuntimeError(f"native audio encode failed for {path!r} "
                           f"(averror {ret})")


def native_media_encode(path: str, frames: np.ndarray | None,
                        fps: float = 10.0,
                        samples: np.ndarray | None = None,
                        sr: int = SAMPLE_RATE,
                        video_codec: str | None = None,
                        frame_map: np.ndarray | None = None,
                        video_bitrate: int | None = None,
                        preset: str | None = None) -> None:
    """Mux video (frames: (N,H,W,3) uint8 RGB) and/or an AAC audio
    track (mono float32 PCM) into one container at `path` — the shape
    real-world library files take. Either stream may be omitted.
    video_codec picks the encoder by libav name (default libx264;
    e.g. "libx265", "libvpx-vp9" for decode-breadth fixtures).
    frame_map (int32 [T]) makes output frame i read frames[frame_map[i]]:
    long fixtures with few distinct frames need MBs, not GBs, of buffer.
    video_bitrate (bps; default 800k) and preset (x264 name; default
    "ultrafast") let realistic-content fixtures carry camera-class
    bitstreams (8-16 Mbps) so decode pays real-file work."""
    import ctypes
    lib = native_decoder()
    if lib is None:
        raise RuntimeError("native audio shim unavailable")
    if frames is not None:
        f = np.ascontiguousarray(frames, np.uint8)
        n_frames, h, w = f.shape[:3]
        rgb = f.ctypes.data_as(ctypes.c_char_p)
        fmap = None
        if frame_map is not None:
            m = np.ascontiguousarray(frame_map, np.int32)
            if len(m) and (m.min() < 0 or m.max() >= n_frames):
                raise ValueError("frame_map index out of range")
            fmap = m.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
            n_frames = len(m)
    else:
        rgb, fmap, n_frames, h, w = None, None, 0, 0, 0
    if samples is not None:
        x = np.ascontiguousarray(samples, np.float32)
        pcm, n_pcm = x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x)
    else:
        pcm, n_pcm = None, 0
    ret = lib.eioku_media_encode_ex(
        path.encode(), rgb, fmap, n_frames, w, h, float(fps), pcm, n_pcm, sr,
        video_codec.encode() if video_codec else None,
        int(video_bitrate or 0), preset.encode() if preset else None)
    if ret != 0:
        raise RuntimeError(f"native media encode failed for {path!r} "
                           f"(averror {ret})")


_sdl_mixer = None


def _get_sdl_mixer():
    """Lazily init SDL_mixer (via pygame) at 16 kHz mono s16 with SDL's dummy
    audio output (no sound device needed); None when unavailable."""
    global _sdl_mixer
    if _sdl_mixer is None:
        os.environ.setdefault("SDL_AUDIODRIVER", "dummy")
        os.environ.setdefault("PYGAME_HIDE_SUPPORT_PROMPT", "1")
        try:
            from pygame import mixer
            # allowedchanges=0: refuse any spec SDL would silently substitute
            mixer.init(frequency=SAMPLE_RATE, size=-16, channels=1,
                       allowedchanges=0)
            got = mixer.get_init()
            if got != (SAMPLE_RATE, -16, 1):
                raise RuntimeError(f"mixer opened at {got}, "
                                   f"need ({SAMPLE_RATE}, -16, 1)")
            _sdl_mixer = mixer
        except Exception as e:  # pygame absent or SDL init failure
            log.warning("SDL audio decode unavailable: %s", e)
            _sdl_mixer = False
    return _sdl_mixer or None


def load_compressed(path: str, target_sr: int = SAMPLE_RATE) -> np.ndarray:
    """Decode mp3/ogg/flac -> float32 mono [-1, 1] at target_sr via SDL_mixer."""
    mixer = _get_sdl_mixer()
    if mixer is None:
        raise RuntimeError(
            f"no decoder available for {path!r} (SDL_mixer failed to load)")
    raw = mixer.Sound(path).get_raw()  # decoded at the mixer's 16 kHz mono s16
    x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    if target_sr != SAMPLE_RATE:
        from math import gcd

        from scipy.signal import resample_poly
        g = gcd(SAMPLE_RATE, target_sr)
        x = resample_poly(x, target_sr // g, SAMPLE_RATE // g).astype(np.float32)
    return x


def load_audio(path: str, target_sr: int = SAMPLE_RATE) -> np.ndarray:
    """Any supported audio source -> float32 mono [-1, 1] at target_sr. Plain
    wavs skip the shim; mp3/ogg/flac fall back to SDL_mixer without it."""
    if path.lower().endswith(".wav"):
        return load_wav(path, target_sr)
    x = native_decode(path, target_sr)
    if x is not None:
        return x
    if path.lower().endswith((".mp3", ".ogg", ".flac")) and \
            native_decoder() is None:
        return load_compressed(path, target_sr)
    raise RuntimeError(f"no audio stream found in {path!r}")


def _decodable_extensions() -> tuple[str, ...]:
    """Audio extensions this process can decode: .m4a/.aac need the shim."""
    if native_decoder() is not None:
        return AUDIO_EXTENSIONS
    return tuple(e for e in AUDIO_EXTENSIONS if e not in (".m4a", ".aac"))


def find_audio_for_video(video_path: str) -> str | None:
    """The audio source for a video: the file itself when it is an audio
    file or a container with an audio track, else a same-basename sidecar
    audio file (wav preferred)."""
    exts = _decodable_extensions()
    if video_path.lower().endswith(exts):
        return video_path
    lib = native_decoder()
    if lib is not None and os.path.isfile(video_path) and \
            lib.eioku_audio_probe(video_path.encode()) == 1:
        return video_path
    base = os.path.splitext(video_path)[0]
    for ext in exts:
        for cand in (base + ext, base + ext.upper()):
            if os.path.isfile(cand):
                return cand
    return None


VAD_FRAME_MS = 30  # energy_vad granularity; window_is_active indexes by this


def window_is_active(activity: np.ndarray, start: int, end: int,
                     sr: int = SAMPLE_RATE) -> bool:
    """True when the sample range [start, end) holds any VAD-active frame."""
    frame = int(sr * VAD_FRAME_MS / 1000)
    f0, f1 = start // frame, min(end // frame, len(activity))
    return f1 <= f0 or bool(activity[f0:f1].any())


def energy_vad(audio: np.ndarray, sr: int = SAMPLE_RATE,
               frame_ms: int = VAD_FRAME_MS,
               threshold_db: float = -40.0) -> np.ndarray:
    """Boolean voice activity per frame_ms frame: log energy above a
    threshold relative to the peak, and above an absolute floor."""
    frame = int(sr * frame_ms / 1000)
    n = len(audio) // frame
    if n == 0:
        return np.zeros(0, bool)
    frames = audio[:n * frame].reshape(n, frame)
    rms = np.sqrt(np.mean(frames ** 2, axis=1) + 1e-12)
    peak = rms.max()
    if peak <= 1e-4:  # digitally silent
        return np.zeros(n, bool)
    db = 20 * np.log10(rms / peak + 1e-10)
    return (db > threshold_db) & (rms > 1e-4)


def compute_vad(audio: np.ndarray, sr: int = SAMPLE_RATE,
                model_cache_dir: str | None = None,
                device: str | torch.device | None = None) -> np.ndarray:
    """Boolean voice activity per VAD_FRAME_MS frame.

    The model VAD (models/vad, on `device`: None is CUDA) when a Silero
    checkpoint under model_cache_dir loads and passes its sanity check and
    the audio is at its 16 kHz; the energy VAD otherwise (random VAD weights
    would gate speech arbitrarily)."""
    # without a checkpoint no device is resolved: the energy VAD needs none
    if model_cache_dir and sr == SAMPLE_RATE and os.path.isfile(
            os.path.join(model_cache_dir, VAD_CHECKPOINT_NAME)):
        from eioku_tpu_torch.models.vad.model import vad_activity
        from eioku_tpu_torch.models.vad.weights import load_vad

        model = load_vad(model_cache_dir, resolve_device(device))
        if model is not None:
            return vad_activity(model, audio, frame_ms=VAD_FRAME_MS)
    return energy_vad(audio, sr)


def split_windows(audio: np.ndarray, sr: int = SAMPLE_RATE,
                  window_s: float = 30.0, vad: bool = True,
                  model_cache_dir: str | None = None,
                  device: str | torch.device | None = None
                  ) -> list[tuple[int, np.ndarray]]:
    """Split audio into fixed windows of window_s seconds (zero-padded last).
    Returns [(start_ms, samples[window])], silent windows dropped when vad
    (the model VAD runs on `device`)."""
    win = int(sr * window_s)
    out: list[tuple[int, np.ndarray]] = []
    activity = compute_vad(audio, sr, model_cache_dir, device) \
        if vad and len(audio) else None
    for start in range(0, max(len(audio), 1), win):
        chunk = audio[start:start + win]
        if len(chunk) == 0:
            break
        if activity is not None and \
                not window_is_active(activity, start, start + win, sr):
            continue  # fully silent window
        if len(chunk) < win:
            chunk = np.pad(chunk, (0, win - len(chunk)))
        out.append((int(start / sr * 1000), chunk.astype(np.float32)))
    return out
