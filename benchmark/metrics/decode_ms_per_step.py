"""Whisper decoder (`models/whisper/decoding.py` `whisper_decode_windows`,
a synchronised span) over the decoder steps it took (prefill steps
included), per step of a whole batch of beam rows."""


def read(r):
    steps = r["counters"].get("decode_steps", 0)
    if not steps:
        return None
    return r["spans"].total("decode") / steps * 1e3
