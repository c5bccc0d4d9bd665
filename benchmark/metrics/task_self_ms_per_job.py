"""Task entry (`ml/engine.py` `run_task`, `ml/transcribe.py`): the self time
of the program's root span `task`, what no span under it covers, per job of
the window."""
from benchmark import program_tasks


def read(r):
    tasks = program_tasks.window_tasks(r)
    if tasks is None:
        return None
    ns = program_tasks.total(tasks, "task", "self_ns")
    return None if ns is None else ns / len(tasks) / 1e6
