"""Postmortem CLI for flight-recorder dumps — files or live engines.

``ServingEngine.run()`` writes a ``flight-<pid>-<time>.jsonl`` when the
serving loop dies (see ``flight_recorder.py``); this renders it:

    python -m paddle_tpu_torch.observability.dump FILE            # timeline
    python -m paddle_tpu_torch.observability.dump FILE --summary  # kind counts
    python -m paddle_tpu_torch.observability.dump FILE --kind preempt
    python -m paddle_tpu_torch.observability.dump FILE --kind adapt  # controller moves
    python -m paddle_tpu_torch.observability.dump FILE --request 17
    python -m paddle_tpu_torch.observability.dump FILE --last 50

``--url http://host:port`` reads the SAME stream from a LIVE engine's
ops plane (``/debug/flight``) instead of a file — every filter above
applies unchanged, so the postmortem workflow and the "what is it
doing right now" workflow are one command:

    python -m paddle_tpu_torch.observability.dump --url http://127.0.0.1:9200 --summary
    python -m paddle_tpu_torch.observability.dump --url http://127.0.0.1:9200 --kind preempt --last 20

Timestamps print relative to the first event in the dump (the ring's
clock is monotonic, not wall time).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from paddle_tpu_torch.observability.flight_recorder import (load_dump,
                                                      parse_dump_lines)

__all__ = ["main"]


def _fmt_event(ev: dict, t0: float) -> str:
    # tolerate hand-made JSONL (load_dump supports it): missing
    # ts/seq/kind render as placeholders, never a traceback
    extra = {k: v for k, v in ev.items()
             if k not in ("seq", "ts", "kind")}
    fields = " ".join(f"{k}={json.dumps(v)}" for k, v in extra.items())
    return (f"{ev.get('ts', t0) - t0:12.6f}s  "
            f"#{ev.get('seq', -1):<8d} "
            f"{ev.get('kind', '?'):<16s} {fields}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.observability.dump",
        description="Render a serving flight-recorder dump (JSONL) "
        "from a file or a live engine's ops plane.")
    ap.add_argument("file", nargs="?", help="dump file written by "
                    "FlightRecorder.save / a ServingEngine crash")
    ap.add_argument("--url", help="base URL of a live ops plane "
                    "(e.g. http://127.0.0.1:9200): read its "
                    "/debug/flight ring instead of a file")
    ap.add_argument("--retries", type=int, default=3,
                    help="attempts against --url before giving up "
                    "(connection refused/reset are retried with "
                    "backoff; HTTP errors are not)")
    ap.add_argument("--retry-delay", type=float, default=0.5,
                    help="base backoff between --url attempts, "
                    "doubled per retry")
    ap.add_argument("--kind", help="only events of this kind (e.g. "
                    "submit, select_slot, retire, preempt, adapt, "
                    "constraint_dead_end; submit/select_slot events "
                    "carry a req_kind field — generate/score/embed)")
    ap.add_argument("--request", type=int,
                    help="only events whose rid/id field matches")
    ap.add_argument("--last", type=int, help="only the last N events "
                    "(after filtering)")
    ap.add_argument("--summary", action="store_true",
                    help="per-kind counts instead of the timeline")
    args = ap.parse_args(argv)
    if (args.file is None) == (args.url is None):
        ap.error("pass exactly one of FILE or --url")

    if args.url is not None:
        import time
        import urllib.error
        import urllib.request

        src = args.url.rstrip("/") + "/debug/flight"
        attempts = max(1, args.retries)
        meta = events = None
        for attempt in range(attempts):
            try:
                with urllib.request.urlopen(src, timeout=10) as resp:
                    meta, events = parse_dump_lines(
                        resp.read().decode().splitlines())
                break
            except urllib.error.HTTPError as e:
                # the plane ANSWERED (404, 500...): retrying won't
                # change the answer — fail immediately
                print(f"error: cannot read {src}: {e}",
                      file=sys.stderr)
                return 2
            except (OSError, json.JSONDecodeError) as e:
                # URLError subclasses OSError: connection refused or
                # reset mid-read — the engine may be restarting or
                # mid-scrape, so a bounded backoff-retry is the right
                # postmortem-tool behavior
                if attempt + 1 >= attempts:
                    print(f"error: cannot read {src} after "
                          f"{attempts} attempts: {e}", file=sys.stderr)
                    return 2
                delay = args.retry_delay * (2 ** attempt)
                print(f"retry {attempt + 1}/{attempts - 1}: {src}: "
                      f"{e} (next attempt in {delay:.1f}s)",
                      file=sys.stderr)
                time.sleep(delay)
    else:
        try:
            meta, events = load_dump(args.file)
        except (OSError, json.JSONDecodeError) as e:
            print(f"error: cannot read {args.file}: {e}",
                  file=sys.stderr)
            return 2

    if meta:
        ctx = meta.get("context") or {}
        line = (f"# dump: reason={meta.get('reason')} "
                f"events={meta.get('events')} "
                f"dropped={meta.get('dropped')} "
                f"(ring capacity {meta.get('capacity')})")
        print(line)
        for k, v in ctx.items():
            print(f"#   {k}: {v}")

    if args.kind is not None:
        events = [e for e in events if e.get("kind") == args.kind]
    if args.request is not None:
        events = [e for e in events
                  if e.get("rid") == args.request
                  or e.get("id") == args.request]
    if args.last is not None:
        events = events[-args.last:]

    if args.summary:
        counts: dict = {}
        for e in events:
            counts[e.get("kind", "?")] = counts.get(e.get("kind", "?"),
                                                    0) + 1
        for kind in sorted(counts):
            print(f"{counts[kind]:8d}  {kind}")
        print(f"{len(events):8d}  TOTAL")
        return 0

    if not events:
        print("(no events match)")
        return 0
    t0 = next((e["ts"] for e in events if "ts" in e), 0.0)
    for ev in events:
        print(_fmt_event(ev, t0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
