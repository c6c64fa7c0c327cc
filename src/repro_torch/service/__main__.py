"""``python -m repro_torch.service``: start the live traffic emulation
service.

Flags mirror the ``repro_torch.scenarios serve`` subcommand; the HTTP
routes are documented in :mod:`repro_torch.service.http`.  The load runs'
workers replay on ``--device`` (``cuda`` unless told otherwise); asking
for ``cuda`` on a host without a card exits non-zero and names it.
"""
import argparse

from repro_torch.core.emulator import Emulator
from repro_torch.device import cli_device
from repro_torch.service.http import serve


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.service",
        description="HTTP load-run service over the emulation fleet")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787,
                    help="0 picks a free port (printed at startup)")
    ap.add_argument("--device", default="cuda",
                    help="device the workers replay on (default cuda; "
                         "cpu runs on the host)")
    args = ap.parse_args(argv)
    serve(args.host, args.port,
          emulator=Emulator(device=cli_device(args.device, ap.prog)))


if __name__ == "__main__":
    main()
