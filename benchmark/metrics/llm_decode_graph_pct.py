"""Moonlight decode (`models/llm/model.py` `DecodeGraph`): the share of the
window's decode steps that replayed the step's CUDA graph, from the
program's `llm_decode_graph_replays` over `llm_decode_steps` over the
window's jobs, in percent: 100 when every step replays, less where a
generation found the graph held by another and decoded eagerly (0 on the
CPU). A program that counts no decode step reads as nothing."""
from benchmark import program_tasks


def read(r):
    tasks = program_tasks.window_tasks(r)
    if tasks is None:
        return None
    steps = program_tasks.counted(tasks, "llm_decode_steps")
    if not steps:
        return None
    return program_tasks.counted(tasks, "llm_decode_graph_replays") / steps * 100
