"""Moonlight prefill (`models/llm/model.py` `prefill` under `ml/summarize.py`
`generate`): the program's own `llm.prefill` span (the prompts through all
layers, the first ids, the job's one synchronisation) over its
`llm_prompt_tokens` counter (real prompt tokens), in ms per 1,000 tokens,
over the window's jobs."""
from benchmark import program_tasks


def read(r):
    tasks = program_tasks.window_tasks(r)
    if tasks is None:
        return None
    ns, tokens = program_tasks.total(tasks, "llm.prefill"), \
        program_tasks.counted(tasks, "llm_prompt_tokens")
    if ns is None or not tokens:
        return None
    return ns / 1e6 / tokens * 1000
