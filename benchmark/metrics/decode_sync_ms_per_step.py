"""Whisper decoder (`models/whisper/decoding.py` `whisper_decode_windows`):
the program's own `decode.sync` span, the step's one wait for the device at
`bool(finished.all())`, over its `decode_steps` counter (prefill steps
included), per step of a whole batch of beam rows, over the window's
jobs."""
from benchmark import program_tasks


def read(r):
    return program_tasks.ms_per_step(r, "decode.sync")
