"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU (as the tests
do); a CUDA request on a host without a card raises instead of falling back.
"""
from __future__ import annotations

import os

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """None means CUDA. Raises RuntimeError when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this host; pass "
                           "device='cpu' to run the port on the CPU")
    return dev


def compute_dtype(device: torch.device) -> torch.dtype:
    """Detector activation type: bf16 on the card (the JAX package's device
    type), fp32 on the CPU, where bf16 convolutions are slow and the parity
    tests compare at fp32."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def compute_dtype_name(device: torch.device) -> str:
    """`compute_dtype` as a model config's `compute_dtype` string."""
    return {torch.bfloat16: "bfloat16", torch.float32: "float32"}[compute_dtype(device)]


def entry_point_device(needs_card: bool = True) -> str | None:
    """The device rule of the port's entry points (API, worker, CLI).

    EIOKU_FORCE_CPU=1 puts their models on the CPU ("cpu"). Otherwise they
    run on CUDA (None, resolved by each model when first needed), and when
    `needs_card` is true a host without a card raises here, at start, rather
    than failing every later request that needs the device."""
    if os.environ.get("EIOKU_FORCE_CPU") == "1":
        return "cpu"
    if needs_card and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this host; set "
                           "EIOKU_FORCE_CPU=1 to run the port on the CPU")
    return None
