"""Moonlight decode (`models/llm/model.py` `decode_step` under
`ml/summarize.py` `generate`): the program's own `llm.decode` span (every
step of a job's rows, ending at the copy of the emitted ids) over its
`llm_decode_steps` counter, in ms per step of a job's rows, over the
window's jobs."""
from benchmark import program_tasks


def read(r):
    tasks = program_tasks.window_tasks(r)
    if tasks is None:
        return None
    ns, steps = program_tasks.total(tasks, "llm.decode"), \
        program_tasks.counted(tasks, "llm_decode_steps")
    if ns is None or not steps:
        return None
    return ns / steps / 1e6
