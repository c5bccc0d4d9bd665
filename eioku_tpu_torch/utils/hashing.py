"""Content and config hashing.

Copy of eioku_tpu/utils/hashing.py for the PyTorch port.

Capability parity: backend/src/services/file_hash_service.py:19-86
(xxhash64 of file contents in 8 KB chunks) and
ml-service/src/utils/hashing.py:12-87 (16-char config/input hashes,
verify_input_hash guarding against file changes between discovery and processing).
"""
from __future__ import annotations

import json
import os
from typing import Any

import xxhash

CHUNK_SIZE = 1 << 20  # 1 MiB chunks: larger than the reference's 8 KB — fewer syscalls


def hash_file(path: str) -> str:
    """xxhash64 hex digest of a file's full contents."""
    h = xxhash.xxh64()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(CHUNK_SIZE)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def compute_input_hash(path: str) -> str:
    """16-char stable hash of an input file."""
    return hash_file(path)[:16]


def compute_config_hash(config: dict[str, Any]) -> str:
    """16-char stable hash of a JSON-serializable config dict (key-order independent)."""
    canonical = json.dumps(config, sort_keys=True, separators=(",", ":"), default=str)
    return xxhash.xxh64(canonical.encode()).hexdigest()[:16]


def verify_input_hash(path: str, expected: str) -> bool:
    if not os.path.exists(path):
        return False
    return compute_input_hash(path) == expected


def verify_file_hash(path: str, expected: str) -> bool:
    if not os.path.exists(path):
        return False
    return hash_file(path) == expected
