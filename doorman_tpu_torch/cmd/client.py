"""One-shot capacity client CLI (port of doorman_tpu/cmd/client.py).

    python -m doorman_tpu_torch.cmd.client --server HOST:PORT RESOURCE WANTS

Capability parity with reference go/cmd/doorman_client/doorman_client.go:
ask the server for capacity on one resource and print the first grant.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import sys

from doorman_tpu_torch.client import Client
from doorman_tpu_torch.utils import flagenv


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="doorman-client",
        description="one-shot doorman capacity request (PyTorch/CUDA port)",
    )
    p.add_argument("--server", default="localhost:15000",
                   help="doorman server address")
    p.add_argument("--client-id", default="",
                   help="client id (default: hostname:pid)")
    p.add_argument("--timeout", type=float, default=30.0,
                   help="seconds to wait for a grant")
    p.add_argument("--tls", action="store_true",
                   help="dial with TLS (system roots)")
    p.add_argument("--tls-ca", default="",
                   help="PEM root certificate to trust (implies TLS)")
    p.add_argument("resource_id", help="resource to ask capacity for")
    p.add_argument("wants", type=float, help="how much capacity to ask for")
    return p


async def run(args: argparse.Namespace) -> int:
    client = await Client.connect(
        args.server, args.client_id or None, minimum_refresh_interval=0.0,
        tls=args.tls, tls_ca=args.tls_ca or None,
    )
    try:
        res = await client.resource(args.resource_id, args.wants)
        capacity = await asyncio.wait_for(
            res.capacity().get(), timeout=args.timeout
        )
        print(f"{args.resource_id}: got {capacity:g} "
              f"(wanted {args.wants:g})")
        return 0
    except asyncio.TimeoutError:
        print(f"{args.resource_id}: no grant within {args.timeout:g}s",
              file=sys.stderr)
        return 1
    finally:
        await client.close()


def main(argv=None) -> None:
    parser = make_parser()
    flagenv.populate(parser)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    raise SystemExit(asyncio.run(run(args)))


if __name__ == "__main__":
    main()
