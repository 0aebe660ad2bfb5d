"""Interactive doorman shell: emulate many clients against one server.

Capability parity with reference go/cmd/doorman_shell/doorman_shell.go:
a REPL holding a set of named emulated clients; `get` claims capacity for
a (client, resource) pair, `release` drops it, `show` prints current
assignments, `master` reports the current master. Commands:

    get <client> <resource> <wants>
    release <client> <resource>
    show <client> | show all
    master
    help
    quit
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import shlex
import sys
from typing import Dict

from doorman_tpu_torch.client import Client
from doorman_tpu_torch.client.client import ClientResource
from doorman_tpu_torch.utils import flagenv

HELP = __doc__.split("Commands:", 1)[1]


class Multiclient:
    """A set of emulated clients keyed by name
    (doorman_shell.go:88-190)."""

    def __init__(self, addr: str, tls: bool = False, tls_ca: str = ""):
        self.addr = addr
        self.tls = tls
        self.tls_ca = tls_ca or None
        self.clients: Dict[str, Client] = {}
        self.resources: Dict[str, Dict[str, ClientResource]] = {}

    async def _client(self, name: str) -> Client:
        client = self.clients.get(name)
        if client is None:
            client = await Client.connect(
                self.addr, name, minimum_refresh_interval=0.0,
                tls=self.tls, tls_ca=self.tls_ca,
            )
            self.clients[name] = client
            self.resources[name] = {}
        return client

    async def get(self, name: str, resource_id: str, wants: float) -> str:
        client = await self._client(name)
        held = self.resources[name]
        if resource_id in held:
            await held[resource_id].ask(wants)
        else:
            held[resource_id] = await client.resource(resource_id, wants)
        res = held[resource_id]
        try:
            capacity = await asyncio.wait_for(res.capacity().get(), 10)
        except asyncio.TimeoutError:
            if res.lease is None:
                return f"{name}: no response for {resource_id}"
            capacity = res.current_capacity()  # unchanged grant: no push
        return f"{name}: {resource_id} = {capacity:g}"

    async def release(self, name: str, resource_id: str) -> str:
        held = self.resources.get(name, {})
        res = held.pop(resource_id, None)
        if res is None:
            return f"{name}: does not hold {resource_id}"
        await self.clients[name].release_resource(res)
        return f"{name}: released {resource_id}"

    def show(self, name: str) -> str:
        lines = []
        names = sorted(self.resources) if name == "all" else [name]
        for n in names:
            for rid, res in sorted(self.resources.get(n, {}).items()):
                lines.append(
                    f"{n}: {rid} wants={res.wants:g} "
                    f"has={res.current_capacity():g}"
                )
        return "\n".join(lines) if lines else "(nothing held)"

    def master(self) -> str:
        for client in self.clients.values():
            return client.master()
        return "(no client connected yet)"

    async def close(self) -> None:
        for client in self.clients.values():
            await client.close()
        self.clients.clear()
        self.resources.clear()


async def eval_line(mc: Multiclient, line: str) -> str:
    """Evaluate one shell command (doorman_shell.go:192-255)."""
    try:
        parts = shlex.split(line)
    except ValueError as e:
        return f"parse error: {e}"
    if not parts:
        return ""
    cmd, args = parts[0], parts[1:]
    try:
        if cmd == "get" and len(args) == 3:
            return await mc.get(args[0], args[1], float(args[2]))
        if cmd == "release" and len(args) == 2:
            return await mc.release(args[0], args[1])
        if cmd == "show" and len(args) == 1:
            return mc.show(args[0])
        if cmd == "master" and not args:
            return mc.master()
        if cmd == "help":
            return HELP.strip()
        if cmd in ("quit", "exit"):
            raise EOFError
    except ValueError as e:
        return f"error: {e}"
    return f"unknown command: {line!r} (try 'help')"


async def repl(addr: str, tls: bool = False, tls_ca: str = "") -> None:
    mc = Multiclient(addr, tls=tls, tls_ca=tls_ca)
    loop = asyncio.get_running_loop()
    try:
        while True:
            try:
                line = await loop.run_in_executor(
                    None, input, "doorman> "
                )
            except (EOFError, KeyboardInterrupt):
                break
            try:
                out = await eval_line(mc, line)
            except EOFError:
                break
            if out:
                print(out)
    finally:
        await mc.close()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="doorman-shell",
        description="interactive doorman-tpu client shell",
    )
    p.add_argument("--server", default="localhost:15000",
                   help="doorman server address")
    p.add_argument("--tls", action="store_true",
                   help="dial with TLS (system roots)")
    p.add_argument("--tls-ca", default="",
                   help="PEM root certificate to trust (implies TLS)")
    flagenv.populate(p)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    try:
        asyncio.run(repl(args.server, tls=args.tls, tls_ca=args.tls_ca))
    except KeyboardInterrupt:
        pass
    print("bye", file=sys.stderr)


if __name__ == "__main__":
    main()
