"""Whisper decoder (`models/whisper/decoding.py` `whisper_decode_windows`):
the program's own `decode.forward` span, the host's launch of each step's
`decoder_step`, over its `decode_steps` counter (prefill steps included),
per step of a whole batch of beam rows, over the window's jobs."""
from benchmark import program_tasks


def read(r):
    return program_tasks.ms_per_step(r, "decode.forward")
