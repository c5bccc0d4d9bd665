"""Whisper encoder (`models/whisper/mel.py` and `model.py` `whisper_encode`,
synchronised spans), per window slot encoded: padding rows and the language
detection's window included, as the encoder computes them."""


def read(r):
    rows = r["counters"].get("encoded_rows", 0)
    if not rows:
        return None
    return (r["spans"].total("mel") + r["spans"].total("encode")) / rows * 1e3
