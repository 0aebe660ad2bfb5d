"""Full master-state snapshots: serialize, checksum, decode.

A snapshot captures everything `server._on_is_master(True)` wipes: every
resource's `LeaseStore` contents (drained in bulk through the stores'
`dump_rows()` API, one C call per native store), each resource's
learning-window clock, the downstream servers' priority-band composition
(`_server_bands`), the config epoch, and the journal sequence number the
snapshot supersedes (replay applies only records AFTER `seq`).

Wire format: a canonical-JSON payload wrapped in an envelope carrying the
format version and a sha256 over the payload bytes. Restore verifies both
and raises `SnapshotError` on any mismatch — the caller's contract is to
fall back to the cold (full learning-mode) path, never to guess.

Standard library only: a copy of the JAX package's module, import
paths aside. SNAPSHOT_FORMAT and the encoding are the reference's, so
either package reads the other's snapshots.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import List, Tuple

SNAPSHOT_FORMAT = 1

# A lease row as persisted: matches the stores' dump_rows() contract.
LeaseRow = Tuple[str, float, float, float, float, int, int]


class SnapshotError(Exception):
    """Version/checksum/framing mismatch: the snapshot is unusable and
    restore must take the cold path."""


@dataclass
class ResourceSnapshot:
    id: str
    learning_mode_end: float
    rows: List[LeaseRow] = field(default_factory=list)


@dataclass
class MasterSnapshot:
    server_id: str
    taken_at: float          # master's clock at capture
    became_master_at: float
    config_epoch: int
    seq: int                 # journal seq this snapshot supersedes
    resources: List[ResourceSnapshot] = field(default_factory=list)
    # [(resource_id, server_id, [priorities])] — the band composition of
    # each downstream server's last GetServerCapacity request.
    server_bands: List[Tuple[str, str, List[int]]] = field(
        default_factory=list
    )


def take_snapshot(server, seq: int) -> MasterSnapshot:
    """Capture the server's live master state (event-loop-consistent:
    the caller runs on the loop or holds the tick boundary)."""
    resources = [
        ResourceSnapshot(
            id=rid,
            learning_mode_end=res.learning_mode_end,
            rows=[tuple(r) for r in res.store.dump_rows()],
        )
        for rid, res in server.resources.items()
    ]
    bands = [
        (rid, sid, sorted(int(p) for p in prios))
        for (rid, sid), prios in server._server_bands.items()
    ]
    return MasterSnapshot(
        server_id=server.id,
        taken_at=server._clock(),
        became_master_at=server.became_master_at,
        config_epoch=server._config_epoch,
        seq=int(seq),
        resources=resources,
        server_bands=sorted(bands),
    )


def encode(snap: MasterSnapshot) -> bytes:
    payload = {
        "server_id": snap.server_id,
        "taken_at": snap.taken_at,
        "became_master_at": snap.became_master_at,
        "config_epoch": snap.config_epoch,
        "seq": snap.seq,
        "resources": [
            {
                "id": r.id,
                "learning_mode_end": r.learning_mode_end,
                "rows": [list(row) for row in r.rows],
            }
            for r in snap.resources
        ],
        "server_bands": [list(b) for b in snap.server_bands],
    }
    body = json.dumps(
        payload, sort_keys=True, separators=(",", ":")
    ).encode()
    envelope = {
        "format": SNAPSHOT_FORMAT,
        "sha256": hashlib.sha256(body).hexdigest(),
        "payload_bytes": len(body),
    }
    header = json.dumps(
        envelope, sort_keys=True, separators=(",", ":")
    ).encode()
    return header + b"\n" + body


def decode(data: bytes) -> MasterSnapshot:
    """Parse + verify; raises SnapshotError on any corruption."""
    header, sep, body = data.partition(b"\n")
    if not sep:
        raise SnapshotError("missing envelope/payload separator")
    try:
        envelope = json.loads(header.decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise SnapshotError(f"unparseable envelope: {e}") from None
    if envelope.get("format") != SNAPSHOT_FORMAT:
        raise SnapshotError(
            f"snapshot format {envelope.get('format')!r} != "
            f"{SNAPSHOT_FORMAT} (refusing cross-version restore)"
        )
    if envelope.get("payload_bytes") != len(body):
        raise SnapshotError(
            f"payload truncated: {len(body)} bytes != "
            f"{envelope.get('payload_bytes')}"
        )
    digest = hashlib.sha256(body).hexdigest()
    if digest != envelope.get("sha256"):
        raise SnapshotError("payload sha256 mismatch")
    try:
        payload = json.loads(body.decode())
        resources = [
            ResourceSnapshot(
                id=r["id"],
                learning_mode_end=float(r["learning_mode_end"]),
                rows=[
                    (
                        str(c), float(e), float(ri), float(h), float(w),
                        int(s), int(p),
                    )
                    for c, e, ri, h, w, s, p in r["rows"]
                ],
            )
            for r in payload["resources"]
        ]
        return MasterSnapshot(
            server_id=str(payload["server_id"]),
            taken_at=float(payload["taken_at"]),
            became_master_at=float(payload["became_master_at"]),
            config_epoch=int(payload["config_epoch"]),
            seq=int(payload["seq"]),
            resources=resources,
            server_bands=[
                (str(rid), str(sid), [int(p) for p in prios])
                for rid, sid, prios in payload.get("server_bands", [])
            ],
        )
    except (KeyError, TypeError, ValueError) as e:
        raise SnapshotError(f"malformed payload: {e}") from None


@dataclass
class SnapshotStats:
    """What the obs gauges carry about the last written snapshot."""

    taken_at: float
    size_bytes: int
    resources: int
    leases: int
