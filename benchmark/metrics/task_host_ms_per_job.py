"""Task entry (`ml/engine.py` `run_task`, `ml/transcribe.py`): a job's wall
less its mel, encoder and decoder spans, per job of the window."""


def read(r):
    spans = r["spans"]
    if not r["jobs"]:
        return None
    device = sum(spans.total(n) for n in ("mel", "encode", "decode"))
    return (r["window_s"] - device) / r["jobs"] * 1e3
