"""Decoder-only language models of the port: Moonlight-16B-A3B
(`deepseek_v3`: latent attention over a latent cache, DeepSeekMoE routing),
run by the `summarization` task (`ml/summarize.py`). No counterpart in the
JAX package."""
