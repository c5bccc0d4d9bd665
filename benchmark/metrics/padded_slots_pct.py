"""Whisper encoder (`ml/transcribe.py`): the share of the window slots the
encoder ran (batches and the language detection's one window) that were
padding, from the program's `padded_slots` and `window_slots` counters over
the window's jobs, in percent."""
from benchmark import program_tasks


def read(r):
    tasks = program_tasks.window_tasks(r)
    if tasks is None:
        return None
    slots = program_tasks.counted(tasks, "window_slots")
    if not slots:
        return None
    return program_tasks.counted(tasks, "padded_slots") / slots * 100
