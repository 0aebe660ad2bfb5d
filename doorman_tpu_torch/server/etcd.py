"""Shared etcd v3 HTTP/JSON gateway client.

One etcd dialect for the whole framework: both the config source
(server/sources.py, reference go/configuration/configuration.go:56-105)
and the election lock (server/election.py, reference
go/server/election/election.go:89-172) speak the v3 gateway exposed by
every etcd >= 3.4 (`/v3/kv/*`, `/v3/lease/*`, `/v3/watch`). The
reference used the v2 client API of its era; v2 is gone from modern
etcd builds, so the TPU framework standardizes on v3.

This image has no etcd client library, so the gateway is urllib over
the JSON transcoding endpoint; callers run it in an executor thread
(control-plane path, latency tolerance is seconds). Integration-tested
against an in-process fake speaking this exact HTTP surface
(tests/fake_etcd.py) plus live failover scenarios in
tests/test_etcd_integration.py.

Standard library only: a copy of the JAX package's module, import
paths aside.
"""

from __future__ import annotations

import base64
import json
import time
import urllib.request
from typing import List, Optional, Tuple


def _b64(data: "str | bytes") -> str:
    if isinstance(data, str):
        data = data.encode()
    return base64.b64encode(data).decode()


def prefix_range_end(prefix: "str | bytes") -> bytes:
    """The exclusive range end covering every key under `prefix` (the
    etcd v3 prefix idiom: last byte + 1, trimming trailing 0xff)."""
    if isinstance(prefix, str):
        prefix = prefix.encode()
    end = bytearray(prefix)
    while end:
        if end[-1] < 0xFF:
            end[-1] += 1
            return bytes(end)
        end.pop()
    return b"\x00"  # prefix was all 0xff: range to the keyspace end


class EtcdGateway:
    """Minimal etcd v3 gateway client: kv get/put/txn, leases, watch."""

    def __init__(self, endpoints: List[str]):
        if not endpoints:
            raise ValueError("etcd gateway needs at least one endpoint")
        self.endpoints = [
            (e if "://" in e else f"http://{e}").rstrip("/")
            for e in endpoints
        ]
        # Where wait_for_change starts its endpoint walk; advanced past
        # endpoints that fail to establish a watch (benign int race when
        # shared across executor threads).
        self._watch_endpoint = 0

    def _failover_budgets(self, timeout: float):
        """Yield (endpoint, per_endpoint_timeout) pairs such that the
        WHOLE failover sequence fits in `timeout`: the remaining budget
        is split evenly across the endpoints not yet tried, so a
        partitioned endpoint (which eats its slice to the last
        millisecond) still leaves the healthy ones a real share, while
        one that fails fast (connection refused) barely dents the
        budget and later endpoints inherit nearly all of it."""
        deadline = time.monotonic() + timeout  # doorman: allow[seeded-determinism]
        for i, endpoint in enumerate(self.endpoints):
            per = (deadline - time.monotonic()) / (len(self.endpoints) - i)  # doorman: allow[seeded-determinism]
            if per <= 0:
                return
            yield endpoint, per

    # The allow[seeded-determinism] marks in this file are deliberate:
    # failover deadlines pace real HTTP requests; chaos replaces the
    # whole gateway (FakeEtcd / injectors), never this layer's clock.
    def _post(self, path: str, payload: dict, timeout: float = 30.0) -> dict:
        data = json.dumps(payload).encode()
        last_err: Exception = RuntimeError("no endpoints")
        for endpoint, per in self._failover_budgets(timeout):
            try:
                req = urllib.request.Request(
                    endpoint + path,
                    data=data,
                    headers={"Content-Type": "application/json"},
                )
                with urllib.request.urlopen(req, timeout=per) as resp:
                    return json.loads(resp.read().decode())
            except Exception as e:  # try the next endpoint
                last_err = e
        raise last_err

    # -- kv ------------------------------------------------------------

    def get(self, key: str, timeout: float = 30.0) -> Optional[bytes]:
        out = self._post("/v3/kv/range", {"key": _b64(key)}, timeout)
        kvs = out.get("kvs", [])
        if not kvs:
            return None
        return base64.b64decode(kvs[0]["value"])

    def put(
        self,
        key: str,
        value: "str | bytes",
        lease_id: int = 0,
        timeout: float = 30.0,
    ) -> None:
        payload = {"key": _b64(key), "value": _b64(value)}
        if lease_id:
            payload["lease"] = str(lease_id)
        self._post("/v3/kv/put", payload, timeout)

    def get_prefix(
        self, prefix: str, timeout: float = 30.0
    ) -> List[Tuple[str, bytes]]:
        """All (key, value) pairs under `prefix`, key-sorted (the v3
        range read the persistence backend's chunked journal uses)."""
        out = self._post(
            "/v3/kv/range",
            {
                "key": _b64(prefix),
                "range_end": _b64(prefix_range_end(prefix)),
                # Server default caps a range at its page size; the
                # snapshot/journal keyspace is pruned to stay well under
                # any realistic page, but ask for no cap explicitly.
                "limit": "0",
            },
            timeout,
        )
        pairs = [
            (
                base64.b64decode(kv["key"]).decode(),
                base64.b64decode(kv.get("value", "")),
            )
            for kv in out.get("kvs", [])
        ]
        return sorted(pairs)

    def delete_prefix(self, prefix: str, timeout: float = 30.0) -> int:
        """Delete every key under `prefix`; returns the deleted count."""
        out = self._post(
            "/v3/kv/deleterange",
            {
                "key": _b64(prefix),
                "range_end": _b64(prefix_range_end(prefix)),
            },
            timeout,
        )
        return int(out.get("deleted", 0))

    def put_if_absent(
        self,
        key: str,
        value: "str | bytes",
        lease_id: int = 0,
        timeout: float = 30.0,
    ) -> bool:
        """Transactional create: put iff the key does not exist
        (compare create_revision == 0, the v3 idiom for the v2
        PrevNoExist acquire the reference election used,
        election.go:112-117). Returns True when the put happened."""
        put_op = {"key": _b64(key), "value": _b64(value)}
        if lease_id:
            put_op["lease"] = str(lease_id)
        out = self._post(
            "/v3/kv/txn",
            {
                "compare": [
                    {
                        "key": _b64(key),
                        "target": "CREATE",
                        "result": "EQUAL",
                        "create_revision": "0",
                    }
                ],
                "success": [{"request_put": put_op}],
                "failure": [],
            },
            timeout,
        )
        return bool(out.get("succeeded"))

    # -- leases ---------------------------------------------------------

    def lease_grant(self, ttl: float, timeout: float = 30.0) -> int:
        out = self._post(
            "/v3/lease/grant", {"TTL": str(max(int(ttl), 1))}, timeout
        )
        return int(out["ID"])

    def lease_keepalive(self, lease_id: int, timeout: float = 30.0) -> float:
        """Refresh the lease; returns the new TTL (0 or negative means
        the lease is gone and the lock key with it)."""
        out = self._post(
            "/v3/lease/keepalive", {"ID": str(lease_id)}, timeout
        )
        result = out.get("result", out)
        return float(result.get("TTL", 0))

    def lease_revoke(self, lease_id: int, timeout: float = 30.0) -> None:
        self._post("/v3/lease/revoke", {"ID": str(lease_id)}, timeout)

    # -- watch ----------------------------------------------------------

    def wait_for_change(self, key: str, timeout: float = 60.0) -> bool:
        """Block until the key changes (or timeout); one-shot watch.

        /v3/watch is a never-closing newline-delimited JSON stream: the
        first frame acknowledges watch creation, each later frame carries
        events. Read frame-by-frame and return on the first event frame.

        Returns True when a watch was actually established (an event
        arrived, the stream closed cleanly, or it idled past the read
        timeout after the creation ack) — the caller keeps fast polling.
        Returns False when every endpoint failed before establishing a
        watch — the caller should escalate its backoff."""
        payload = {"create_request": {"key": _b64(key)}}
        # Unlike _post, each endpoint gets the FULL remaining budget:
        # splitting it would shrink the idle window of a perfectly
        # healthy watch to timeout/n, multiplying the caller's re-watch
        # + get-poll churn by the endpoint count. Failover instead works
        # across calls: an endpoint that fails before establishing a
        # watch is skipped on the next call (the caller loops), so one
        # burned cycle moves the watch to a healthy endpoint for good.
        deadline = time.monotonic() + timeout  # doorman: allow[seeded-determinism]
        n = len(self.endpoints)
        start = self._watch_endpoint  # snapshot: the loop mutates it
        for j in range(n):
            per = deadline - time.monotonic()  # doorman: allow[seeded-determinism]
            if per <= 0:
                break
            i = (start + j) % n
            endpoint = self.endpoints[i]
            established = False
            try:
                req = urllib.request.Request(
                    endpoint + "/v3/watch",
                    data=json.dumps(payload).encode(),
                    headers={"Content-Type": "application/json"},
                )
                with urllib.request.urlopen(req, timeout=per) as resp:
                    while True:
                        line = resp.readline()
                        if not line:
                            break  # stream closed
                        try:
                            frame = json.loads(line.decode())
                        except ValueError:
                            break  # not a watch stream (proxy error?)
                        established = True  # got a frame (creation ack)
                        result = frame.get("result", frame)
                        if result.get("events"):
                            self._watch_endpoint = i
                            return True  # the key changed
                        # else: keep waiting for an event frame
            except Exception:
                pass  # timeout or transport failure; classified below
            if established:
                # Idle timeout, or a clean close after the creation
                # ack: a live watch existed, just no change within
                # `timeout`.
                self._watch_endpoint = i
                return True
            # The endpoint never produced a watch frame — including a
            # connectable endpoint whose stream closes instantly with
            # an empty or non-JSON body (degenerate proxy). Pinning
            # such an endpoint would make it permanently sticky; start
            # the next call (and the next iteration) past it.
            self._watch_endpoint = (i + 1) % n
        return False
