#!/usr/bin/env python3
"""Ops CLI for a running action server of the PyTorch port (Pi-0 or
OpenVLA: the same protocol), on the port's client.

    python scripts/serve_ctl_torch.py stats  --port 8787
    python scripts/serve_ctl_torch.py reload /path/to/pi0.pt --port 8787 [--drop-first]

The port's counterpart of scripts/serve_ctl.py. `stats` prints the server's
counters (health check, request / error / rejected totals, latency
percentiles, batch occupancy, the live checkpoint, the reload count) as
JSON. `reload` swaps the weights while the server runs, loading the path as
its startup --checkpoint would ('random' draws them again from its seed);
--drop-first frees the old weights before loading, for models too big to
hold twice. A refused reload prints the server's error to stderr and exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("stats", help="print the server's stats")
    pr = sub.add_parser("reload", help="hot-reload the server's weights")
    pr.add_argument("path", type=str,
                    help="a checkpoint the server's startup --checkpoint accepts "
                         "('random' draws the weights again)")
    pr.add_argument("--drop-first", action="store_true",
                    help="free the old weights before loading (not atomic)")
    for q in (ps, pr):
        q.add_argument("--host", type=str, default="127.0.0.1")
        q.add_argument("--port", type=int, default=8787)
    return p.parse_args(argv)


def main(argv=None) -> int:
    from blurr_tpu_torch.serving.client import ActionClient

    args = parse_args(argv)
    with ActionClient(args.host, args.port) as client:
        try:
            out = (client.stats() if args.cmd == "stats"
                   else client.reload(args.path, drop_first=args.drop_first))
        except RuntimeError as exc:  # the server's {"error": ...} answer
            print(f"error: {exc}", file=sys.stderr)
            return 1
    print(json.dumps(out, indent=2, sort_keys=True, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
