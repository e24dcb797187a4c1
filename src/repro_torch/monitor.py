"""Terminal dashboard: render or tail a ``watch()`` NDJSON frame stream.

Usage:
    python -m repro_torch.monitor run.ndjson              # render a finished run
    python -m repro_torch.monitor --follow run.ndjson     # tail a live run (Fig. 5)

The stream comes from ``repro_torch.core.monitor.watch(...,
sink=NDJSONSink(path))`` in any other process.  This command only reads the
file and needs no device.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.core.monitor import follow_stream


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.monitor",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("stream", help="NDJSON frame stream written by monitor.watch")
    ap.add_argument("--follow", action="store_true",
                    help="keep tailing the file as it grows (live dashboard)")
    ap.add_argument("--every", type=int, default=1, help="render every Nth frame")
    ap.add_argument("--no-clear", action="store_true",
                    help="append frames instead of redrawing in place")
    ap.add_argument("--timeout", type=float, default=None,
                    help="with --follow: give up after this many idle seconds")
    args = ap.parse_args(argv)
    try:
        shown = follow_stream(args.stream, follow=args.follow, every=max(args.every, 1),
                              clear=not args.no_clear, timeout_s=args.timeout)
    except FileNotFoundError:
        print(f"no such stream: {args.stream}", file=sys.stderr)
        return 2
    except KeyboardInterrupt:
        return 130
    if shown == 0:
        print("(no frames in stream)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
