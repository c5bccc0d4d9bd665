"""CLI entrypoint: run the API service of the PyTorch port.

Usage: python -m eioku_tpu_torch.api.main [--config PATH] [--host H] [--port N]
       [--db URL] [--no-discover]

Port of eioku_tpu/api/main.py. The semantic and visual indexes and the
reranker run on CUDA; EIOKU_FORCE_CPU=1 puts them on the CPU instead. With
semantic_search or visual_search on (both are by default) and no card, the
service raises at start: it never serves searches that would fail on every
request, and it never carries on on the CPU.
"""
from __future__ import annotations

import argparse

from eioku_tpu_torch.api.app import build_context, create_app
from eioku_tpu_torch.config.settings import load_config
from eioku_tpu_torch.utils.device import entry_point_device
from eioku_tpu_torch.utils.logging import setup_logging
from eioku_tpu_torch.web.server import run


def main() -> None:
    parser = argparse.ArgumentParser(description="eioku PyTorch/CUDA API service")
    parser.add_argument("--config", default=None, help="path to config JSON")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--db", default=None, help="database URL override")
    parser.add_argument("--no-discover", action="store_true",
                        help="skip startup video discovery")
    args = parser.parse_args()

    setup_logging("eioku-api")
    config = load_config(args.config)
    if args.db:
        config.database_url = args.db
    if args.no_discover:
        config.auto_discover = False
    device = entry_point_device(config.semantic_search or config.visual_search)
    app = create_app(ctx=build_context(config, device=device))
    run(app, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
