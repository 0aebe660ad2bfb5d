"""TLS on every hop of the port, held against the JAX package: the
server's gRPC port (`start(tls_cert=, tls_key=)`), the frontend workers'
public port (`attach_frontend(tls_cert=, tls_key=)`, the backend hop in
the clear) and the intermediate's dial to its parent (`parent_tls_ca`).

  * the reference's three cases (tests/test_tls.py) on the port: end to
    end with a client pinning the self-signed root (and a plaintext
    client failing instead of hanging), frontend workers terminating
    TLS, and the both-or-neither refusal;
  * the parent dial over TLS, equal to a plaintext twin's exchange;
  * a port client against a reference server over TLS, and a reference
    client against a port server over TLS, each grant equal to the
    same-package pair's.

The port runs with device="cpu". Every wait is bounded.
"""

import asyncio
import shutil
import socket
import subprocess
import time

import grpc
import pytest

import tests.conftest  # noqa: F401

from doorman_tpu.client import Client as JClient
from doorman_tpu.server.config import parse_yaml_config as j_parse
from doorman_tpu.server.election import TrivialElection as JElection
from doorman_tpu.server.server import CapacityServer as JServer
from doorman_tpu_torch.algorithms import Request
from doorman_tpu_torch.client import Client
from doorman_tpu_torch.proto import doorman_pb2 as pb
from doorman_tpu_torch.proto.grpc_api import CapacityStub
from doorman_tpu_torch.server.config import parse_yaml_config
from doorman_tpu_torch.server.election import TrivialElection
from doorman_tpu_torch.server.server import (
    CapacityServer,
    default_resource_template,
)

CONFIG = """
resources:
- identifier_glob: "*"
  capacity: 100
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0}
"""

needs_openssl = pytest.mark.skipif(
    shutil.which("openssl") is None, reason="openssl not available"
)


@pytest.fixture
def certs(tmp_path):
    key, cert = tmp_path / "key.pem", tmp_path / "cert.pem"
    subprocess.run(
        [
            "openssl", "req", "-x509", "-newkey", "rsa:2048",
            "-keyout", str(key), "-out", str(cert),
            "-days", "1", "-nodes",
            "-subj", "/CN=localhost",
            "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1",
        ],
        check=True,
        capture_output=True,
        timeout=60,
    )
    return str(cert), str(key)


async def _server(pkg, tls=None, **kw):
    """A configured immediate-mode root of either package, on loopback,
    with TLS when `tls` is a (cert, key) pair; (server, port)."""
    if pkg == "port":
        server = CapacityServer("s", TrivialElection(),
                                minimum_refresh_interval=0.0, device="cpu",
                                flightrec_capacity=0, **kw)
        cfg = parse_yaml_config(CONFIG)
    else:
        server = JServer("s", JElection(), minimum_refresh_interval=0.0,
                         flightrec_capacity=0, **kw)
        cfg = j_parse(CONFIG)
    cert, key = tls or (None, None)
    port = await server.start(0, host="127.0.0.1", tls_cert=cert,
                              tls_key=key)
    await server.load_config(cfg)
    await asyncio.sleep(0)
    server.current_master = ""  # no redirects in these cases
    return server, port


async def _grants(client_cls, port, tls_ca=None, asks=(("r0", 25.0),)):
    """The first grant of each (resource, wants) of one client."""
    client = await client_cls.connect(
        f"localhost:{port}", "tls-client", minimum_refresh_interval=0.0,
        tls_ca=tls_ca,
    )
    try:
        out = []
        for rid, wants in asks:
            res = await client.resource(rid, wants=wants)
            out.append(await asyncio.wait_for(res.capacity().get(), 10))
        return out
    finally:
        await client.close()


@needs_openssl
def test_tls_end_to_end(certs):
    cert, key = certs

    async def body():
        server, port = await _server("port", tls=(cert, key))
        try:
            assert await _grants(Client, port, tls_ca=cert) == [25.0]
            # A plaintext client against the TLS port must fail, not
            # hang forever: bounded retries surface the handshake error.
            plain = await Client.connect(
                f"localhost:{port}", "plain-client",
                minimum_refresh_interval=0.0,
            )
            plain.conn.max_retries = 1
            res2 = await plain.resource("r0", wants=5)
            with pytest.raises(asyncio.TimeoutError):
                await asyncio.wait_for(res2.capacity().get(), timeout=2)
            await plain.close()
        finally:
            await server.stop()

    asyncio.run(body())


@needs_openssl
def test_frontend_workers_terminate_tls(certs):
    """TLS terminates at the real pool's listener workers: a secure
    channel pinning the self-signed root gets a grant through the
    worker's unary forward (the backend hop stays plaintext), while a
    plaintext client against the same port fails instead of hanging."""
    cert, key = certs

    async def body():
        server = CapacityServer(
            "tls-frontend", TrivialElection(), mode="immediate",
            tick_interval=0.2, minimum_refresh_interval=0.0,
            stream_push=True, stream_shards=2, device="cpu",
        )
        pool = server.attach_frontend(
            1, ring_bytes=1 << 18, inline=False,
            tls_cert=cert, tls_key=key,
        )
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            public_port = s.getsockname()[1]
        public_addr = f"127.0.0.1:{public_port}"
        try:
            backend_port = await server.start(0, host="127.0.0.1")
            await server.load_config(parse_yaml_config(CONFIG))
            await asyncio.sleep(0)
            server.current_master = public_addr
            await pool.start(public_addr, f"127.0.0.1:{backend_port}")
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                if pool.control.status()["worker_held"]:
                    break
                await asyncio.sleep(0.2)
            else:
                raise TimeoutError("worker never became ready")

            with open(cert, "rb") as f:
                root = f.read()
            creds = grpc.ssl_channel_credentials(root_certificates=root)
            req = pb.GetCapacityRequest(client_id="tls-fe-client")
            rr = req.resource.add()
            rr.resource_id = "r0"
            rr.wants = 25.0
            rr.priority = 1
            async with grpc.aio.secure_channel(
                f"localhost:{public_port}", creds
            ) as ch:
                resp = await CapacityStub(ch).GetCapacity(req, timeout=30)
                assert resp.response[0].gets.capacity == 25.0
            async with grpc.aio.insecure_channel(public_addr) as ch:
                with pytest.raises(
                    (grpc.aio.AioRpcError, asyncio.TimeoutError)
                ):
                    await asyncio.wait_for(
                        CapacityStub(ch).GetCapacity(req), timeout=5
                    )
        finally:
            await asyncio.wait_for(pool.stop(), 30)
            await server.stop()

    asyncio.run(body())


def test_tls_requires_both_cert_and_key():
    async def body():
        server = CapacityServer("s", TrivialElection(), device="cpu")
        with pytest.raises(ValueError, match="both be set"):
            await server.start(0, host="127.0.0.1", tls_cert="/nope.pem")
        with pytest.raises(ValueError, match="both be set"):
            await server.start(0, host="127.0.0.1", tls_key="/nope.pem")
        # The real frontend pool refuses a half pair too.
        streams = CapacityServer("f", TrivialElection(), device="cpu",
                                 stream_push=True)
        with pytest.raises(ValueError, match="both be set"):
            streams.attach_frontend(1, inline=False, tls_cert="/nope.pem")

    asyncio.run(body())


async def _parent_exchange(cert=None, key=None):
    """A port root (TLS when given a pair) and a port intermediate that
    dials it (pinning `cert` when given); one parent exchange driven by
    hand. Returns the exchange's (interval, retry) and the intermediate's
    capacity per resource."""
    root, port = await _server("port", tls=(cert, key) if cert else None)
    inter = CapacityServer(
        "inter", TrivialElection(), device="cpu", flightrec_capacity=0,
        minimum_refresh_interval=0.0, parent_tls_ca=cert,
    )
    try:
        # Started as a root so no updater runs on the real clock; the
        # exchange is driven by hand.
        await inter.start(0, host="127.0.0.1")
        inter.parent_addr = f"localhost:{port}"
        await inter.load_config(
            pb.ResourceRepository(resources=[default_resource_template()]),
            {},
        )
        await asyncio.sleep(0)
        for rid, wants in (("a", 30.0), ("b", 12.0)):
            inter._decide(rid, Request("c1", 0.0, wants, 1, priority=2))
        got = await asyncio.wait_for(inter._perform_parent_requests(0), 30)
        return got, {rid: res.capacity
                     for rid, res in sorted(inter.resources.items())}
    finally:
        await inter.stop()
        await root.stop()


@needs_openssl
def test_parent_dial_over_tls(certs):
    """An intermediate with parent_tls_ca against a TLS root converges
    exactly as its plaintext twin does against a plaintext root."""
    cert, key = certs
    got = asyncio.run(_parent_exchange(cert, key))
    assert got[1] == {"a": 30.0, "b": 12.0}
    assert got[0][1] == 0  # no retry: the exchange landed
    assert got == asyncio.run(_parent_exchange())


@needs_openssl
@pytest.mark.parametrize("client_pkg,server_pkg", [
    ("port", "ref"), ("ref", "port"),
])
def test_tls_across_packages(certs, client_pkg, server_pkg):
    """Each package's client against the other's TLS server: the grants
    equal the same-package pair's over TLS."""
    cert, key = certs
    client_cls = {"port": Client, "ref": JClient}
    asks = (("r0", 25.0), ("r1", 130.0), ("r2", 0.0))

    async def grants(cpkg, spkg):
        server, port = await _server(spkg, tls=(cert, key))
        try:
            return await _grants(client_cls[cpkg], port, tls_ca=cert,
                                 asks=asks)
        finally:
            await server.stop()

    got = asyncio.run(grants(client_pkg, server_pkg))
    assert got == [25.0, 100.0, 0.0]
    assert got == asyncio.run(grants(server_pkg, server_pkg))
