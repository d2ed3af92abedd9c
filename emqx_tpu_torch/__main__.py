"""Broker entrypoint: `python -m emqx_tpu_torch [-c config.json] [--port 1883]`.

The `bin/emqx foreground` analog (reference: bin/emqx:75-110), the port's
copy of `emqx_tpu/__main__.py` with its flags. Boots the application
(app.py: broker, extensions, listeners, housekeeping) from a config file
plus EMQX_TPU__* env overrides on the CUDA device, prints one
"emqx_tpu_torch listener <type>:<name> on <host>:<port>" line a listener,
and runs until SIGINT/SIGTERM, which stop the app (its final flush
included) and exit 0. ``--no-tpu`` routes on the CPU trie alone, without
a card; without it and without CUDA the app refuses to boot.
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="emqx_tpu_torch", description=__doc__)
    ap.add_argument("-c", "--config", default=None, help="JSON config file")
    ap.add_argument("--host", default=None, help="override listener bind")
    ap.add_argument("--port", type=int, default=None, help="override listener port")
    ap.add_argument(
        "--no-tpu", action="store_true",
        help="route on the CPU trie only (skip the CUDA engine)",
    )
    ap.add_argument(
        "--no-dashboard", action="store_true", help="disable the REST API"
    )
    args = ap.parse_args(argv)
    return asyncio.run(serve(args))


async def serve(args) -> int:
    from emqx_tpu_torch.app import BrokerApp
    from emqx_tpu_torch.config.schema import load_file

    config = load_file(args.config)
    if args.host is not None:
        config.listeners[0].bind = args.host
    if args.port is not None:
        config.listeners[0].port = args.port
    if args.no_tpu:
        config.router.enable_tpu = False
    if args.no_dashboard:
        config.dashboard.enable = False

    app = BrokerApp(config)
    await app.start()
    for l in app.listeners.list().values():
        print(
            f"emqx_tpu_torch listener {l.config.type}:{l.config.name} on "
            f"{l.config.bind}:{l.port}",
            flush=True,
        )

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    print("shutting down", flush=True)
    await app.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
