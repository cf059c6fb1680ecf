"""CLI entry point: `python -m repro_torch.server [--port N] [--clock wall]
[--device cuda]`.

Builds the smoke-model engine described by the flags on `--device` (a
card by default; without one it raises), binds, prints `LISTENING <port>`
on stdout (callers that start it as a subprocess wait for that line),
and serves until SIGTERM/SIGINT — which
triggers a graceful drain: new streams get 503, live ones finish within
--drain-timeout, then the process exits 0.
"""
from __future__ import annotations

import argparse
import signal
import sys
import threading

from repro_torch.server.app import ServerConfig, ServingServer


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.server",
                                description="Andes HTTP/SSE serving frontend")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 = OS-assigned (printed as LISTENING <port>)")
    p.add_argument("--arch", default="llama3-8b")
    p.add_argument("--clock", choices=("wall", "virtual"), default="wall")
    p.add_argument("--scheduler", default="andes")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-seq", type=int, default=64)
    p.add_argument("--queue-depth", type=int, default=256)
    p.add_argument("--drain-timeout", type=float, default=10.0)
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (cuda, or cpu)")
    args = p.parse_args(argv)

    cfg = ServerConfig(host=args.host, port=args.port, arch=args.arch,
                       clock=args.clock, scheduler=args.scheduler,
                       num_slots=args.slots, max_seq=args.max_seq,
                       queue_depth=args.queue_depth,
                       drain_timeout=args.drain_timeout,
                       warmup=not args.no_warmup)
    server = ServingServer(cfg, device=args.device)
    stop = threading.Event()

    def on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)

    port = server.start()
    print(f"LISTENING {port}", flush=True)
    stop.wait()
    phase = server.shutdown(drain=True)
    print(f"DRAINED {phase}", flush=True)
    return 0 if phase == "done" else 1


if __name__ == "__main__":
    sys.exit(main())
