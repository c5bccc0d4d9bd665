"""Kimi-Linear KDA (`models/llm/kimi_linear.py`: the layers' token mixing
under the profiler ranges `llm.kda` in `prefill`): the device time of the
kernels launched under those ranges over that of the whole traced prefill
(the profiler slice's one job), in percent. A program without the ranges
reads as nothing."""


def read(r):
    kda, whole = r.get("kda_device_s"), r.get("prefill_device_s")
    if not kda or not whole:
        return None
    return kda / whole * 100
