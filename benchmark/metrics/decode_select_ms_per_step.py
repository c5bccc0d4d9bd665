"""Whisper decoder (`models/whisper/decoding.py` `whisper_decode_windows`):
the program's own `decode.select` span, the logit rules, the log-softmax,
the beams' stable top-k over every candidate and the reorder of the caches,
up to the token's write, over its `decode_steps` counter (prefill steps
included), per step of a whole batch of beam rows, over the window's
jobs."""
from benchmark import program_tasks


def read(r):
    return program_tasks.ms_per_step(r, "decode.select")
