"""One engine process wearing both HTTP planes — the fleet's unit.

The port's copy of ``paddle_tpu/inference/fleet/engine_proc.py``. Two
modes, both driven by one JSON config (model geometry + engine knobs),
so every process of a fleet is built identically and a snapshot taken
on one restores on another:

**Serve** (default)::

    python -m paddle_tpu_torch.inference.fleet.engine_proc \\
        --config '{"model": {...GPTConfig kwargs...},
                   "model_seed": 1234,
                   "engine": {...FrontDoor kwargs...}}'

Builds the model deterministically (``GPTForCausalLM(..., seed=
model_seed)``: the port's seeded generator, so the same seed gives the
same weights, the property a cross-process restore leans on), starts a
:class:`FrontDoor` with the ingest and ops planes on ephemeral (or
given) ports, and prints ONE ready line::

    READY {"ingest_url": "http://...", "ops_url": "http://...", "pid": N}

then serves until stdin reaches EOF or SIGTERM/SIGINT arrives (the
parent owns the lifetime by owning the pipe). The kernels' launch
counts of the process show on its ops plane's ``/metrics`` as
``kernel_launches{kernel="K2"}`` and so on (refreshed per scrape), and
on the way out it prints them::

    EXIT {"launches": {"K2": n, "K4": n, "K5": n, ...}}

**Oneshot restore** (``--oneshot-restore PATH``) builds the same engine
WITHOUT the HTTP planes, restores the request snapshot at PATH (a
checkpoint directory or a byte-frame file), runs it to completion and
prints::

    RESULT {"tokens": [...], "finish_reason": "...", "outcome": "...",
            "launches": {...}}

The device comes from the config's ``"engine"`` keywords: ``"cuda"``
unless the config says ``"device": "cpu"``, and the model is built
there. Without a card a ``"cuda"`` config raises; nothing falls back to
the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading


def _build_model(config: dict):
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    device = config.get("engine", {}).get("device", "cuda")
    model = GPTForCausalLM(GPTConfig(**config.get("model", {})),
                           device=device,
                           seed=int(config.get("model_seed", 0)))
    model.eval()
    return model


def _launches() -> dict:
    """This process's kernel launch counts (K2, K4, K5 and the int8
    branches)."""
    from paddle_tpu_torch.ops.kernels import chunk_prefill as k5
    from paddle_tpu_torch.ops.kernels import layer_norm as k2
    from paddle_tpu_torch.ops.kernels import paged_attention as k4

    return {"K2": k2.launches, "K4": k4.launches, "K5": k5.launches,
            "K4-int8": k4.launches_q, "K5-int8": k5.launches_q}


def _publish_launches(engine) -> None:
    """Refresh a ``kernel_launches{kernel}`` gauge with this process's
    launch counts on every ``/metrics`` scrape (the ops plane calls
    ``publish_load_gauges`` per scrape)."""
    gauge = engine.telemetry.registry.gauge(
        "kernel_launches",
        "hand-written kernel launches in this process, by kernel",
        labelnames=("kernel",))
    publish = engine.publish_load_gauges

    def publish_with_launches():
        publish()
        for name, n in _launches().items():
            gauge.labels(kernel=name).set(float(n))

    engine.publish_load_gauges = publish_with_launches


def _serve(config: dict, args) -> int:
    from paddle_tpu_torch.inference.frontend import FrontDoor

    model = _build_model(config)
    door = FrontDoor(model,
                     ingest_port=args.ingest_port,
                     ops_port=args.ops_port,
                     **config.get("engine", {}))
    _publish_launches(door.engine)
    door.start()
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    print("READY " + json.dumps({"ingest_url": door.ingest.url,
                                 "ops_url": door.ops.url,
                                 "pid": os.getpid()}), flush=True)
    # the parent owns the lifetime through the pipe: EOF (or a signal)
    # ends us
    waiter = threading.Thread(
        target=lambda: (sys.stdin.read(), stop.set()), daemon=True)
    waiter.start()
    stop.wait()
    door.stop(drain=not args.no_drain)
    print("EXIT " + json.dumps({"launches": _launches()}), flush=True)
    return 0


def _oneshot_restore(config: dict, source_path: str) -> int:
    from paddle_tpu_torch.inference.serving import ServingEngine

    model = _build_model(config)
    kw = dict(config.get("engine", {}))
    # FrontDoor-only routing keys: a oneshot restore has no router and
    # no /readyz, so a prefill-tagged config restores on a bare engine
    kw.pop("role", None)
    kw.pop("prefill_backlog_limit", None)
    eng = ServingEngine(model, **kw)
    source = source_path
    if os.path.isfile(source_path):
        with open(source_path, "rb") as f:
            source = f.read()      # byte-frame file -> bytes API
    req = eng.restore_request(source)
    eng.run()
    print("RESULT " + json.dumps({
        "tokens": [int(t) for t in req.tokens],
        "finish_reason": req.finish_reason,
        "outcome": getattr(req, "_restore_outcome", None),
        "launches": _launches()}), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.inference.fleet.engine_proc",
        description="one fleet engine process (serve or oneshot "
                    "restore)")
    p.add_argument("--config", required=True,
                   help="JSON: {model, model_seed, engine}")
    p.add_argument("--ingest-port", type=int, default=0)
    p.add_argument("--ops-port", type=int, default=0)
    p.add_argument("--no-drain", action="store_true",
                   help="stop without draining on exit")
    p.add_argument("--oneshot-restore", metavar="PATH", default=None,
                   help="restore the request snapshot at PATH "
                        "(dir or byte-frame file), run to completion, "
                        "print RESULT, exit")
    args = p.parse_args(argv)
    config = json.loads(args.config)
    if args.oneshot_restore:
        return _oneshot_restore(config, args.oneshot_restore)
    return _serve(config, args)


if __name__ == "__main__":
    sys.exit(main())
