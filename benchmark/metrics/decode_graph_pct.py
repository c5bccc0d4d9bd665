"""Whisper decoder (`models/whisper/model.py` `decoder_step`): the share of
the window's decoder steps (prefill steps included, as `decode_steps`
counts them) that replayed the step's CUDA graph, from the program's
`decode_graph_replays` and `decode_steps` counters over the window's jobs,
in percent. A program without the replay counter reads as nothing."""
from benchmark import program_tasks


def read(r):
    tasks = program_tasks.window_tasks(r)
    if tasks is None or not any("decode_graph_replays" in t["counters"] for t in tasks):
        return None
    steps = program_tasks.counted(tasks, "decode_steps")
    if not steps:
        return None
    return program_tasks.counted(tasks, "decode_graph_replays") / steps * 100
