"""Audio front end (`ml/audio_io.py`: finding the sidecar, loading it, the
VAD and `split_windows`), per job of the window."""


def read(r):
    if not r["jobs"] or not r["spans"].records.get("audio_prep"):
        return None
    return r["spans"].total("audio_prep") / r["jobs"] * 1e3
