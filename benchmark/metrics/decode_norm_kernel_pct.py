"""Whisper decoder (`models/whisper/model.py` `decoder_step`): the share of
the window's decoder steps (prefill steps included, as `decode_steps`
counts them) whose residual adds and LayerNorms went through the
hand-written add-and-LayerNorm kernel (`ops/add_layer_norm.py`): a replay
of a graph captured with it, or an eager step that launched it. From the
program's `decode_norm_kernel_steps` and `decode_steps` counters over the
window's jobs, in percent. A program without the counter reads as
nothing."""
from benchmark import program_tasks


def read(r):
    tasks = program_tasks.window_tasks(r)
    if tasks is None or not any("decode_norm_kernel_steps" in t["counters"] for t in tasks):
        return None
    steps = program_tasks.counted(tasks, "decode_steps")
    if not steps:
        return None
    return program_tasks.counted(tasks, "decode_norm_kernel_steps") / steps * 100
