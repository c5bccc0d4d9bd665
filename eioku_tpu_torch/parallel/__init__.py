"""Batch-parallel inference over several devices, and training (port of
eioku_tpu/parallel/)."""
