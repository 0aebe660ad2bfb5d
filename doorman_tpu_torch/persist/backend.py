"""Pluggable durability backends for lease-state snapshots + journal.

Two storage shapes behind one interface:

  * `file:` — a directory on a filesystem the next master can read
    (local disk for single-node restarts, shared storage for warm
    takeover across machines). Snapshots are written tmp + fsync +
    atomic rename so a crash mid-write never corrupts the last good
    snapshot; journal appends are fsync'd per flush batch.
  * `etcd:` — the framework's existing etcd v3 gateway
    (doorman_tpu_torch/server/etcd.py). etcd caps a single value at ~1.5MB,
    so snapshots are split into chunks under a generation-numbered
    prefix and switched atomically by rewriting one meta key; journal
    batches append as sequence-numbered keys under `<prefix>/journal/`.

The backend stores OPAQUE bytes; framing, checksums and record parsing
live in snapshot.py / journal.py, so a partially-written or corrupt
payload surfaces there (and restore falls back to the cold path) rather
than here.

Standard library only (the etcd backend imports server/etcd.py when
built): a copy of the JAX package's module, import paths aside.
"""

from __future__ import annotations

import os
import tempfile
from typing import List, Optional, Sequence

# Conservative chunk size for etcd values: the default server caps a
# request at 1.5MiB; half that leaves headroom for base64 + JSON framing
# on the gateway's JSON transcoding.
ETCD_CHUNK_BYTES = 512 * 1024


class PersistBackend:
    """Interface: snapshot slot (atomic replace) + append-only journal."""

    def write_snapshot(self, data: bytes) -> None:
        raise NotImplementedError

    def read_snapshot(self) -> Optional[bytes]:
        raise NotImplementedError

    def append_journal(self, records: Sequence[bytes]) -> None:
        """Append records (framed lines WITHOUT trailing newline)."""
        raise NotImplementedError

    def read_journal(self) -> List[bytes]:
        """All journal lines, oldest first (framing not validated)."""
        raise NotImplementedError

    def reset_journal(self, records: Sequence[bytes] = ()) -> None:
        """Atomically replace the journal (post-snapshot / compaction)."""
        raise NotImplementedError


class MemoryBackend(PersistBackend):
    """In-process backend: tests and the chaos runner's shared-storage
    topology (several servers handed the SAME instance model a shared
    snapshot store without filesystem coupling)."""

    def __init__(self):
        self._snapshot: Optional[bytes] = None
        self._journal: List[bytes] = []

    def write_snapshot(self, data: bytes) -> None:
        self._snapshot = bytes(data)

    def read_snapshot(self) -> Optional[bytes]:
        return self._snapshot

    def append_journal(self, records: Sequence[bytes]) -> None:
        self._journal.extend(bytes(r) for r in records)

    def read_journal(self) -> List[bytes]:
        return list(self._journal)

    def reset_journal(self, records: Sequence[bytes] = ()) -> None:
        self._journal = [bytes(r) for r in records]


class FileBackend(PersistBackend):
    """Directory layout: `snapshot.bin` (atomic slot) + `journal.log`
    (newline-framed appends). A crash mid-append can leave a truncated
    final line; journal.read_records tolerates exactly that."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._snap_path = os.path.join(root, "snapshot.bin")
        self._journal_path = os.path.join(root, "journal.log")

    def _replace(self, path: str, data: bytes) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.root, prefix=".tmp_persist_")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        # Durability of the rename itself: fsync the directory.
        dirfd = os.open(self.root, os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)

    def write_snapshot(self, data: bytes) -> None:
        self._replace(self._snap_path, data)

    def read_snapshot(self) -> Optional[bytes]:
        try:
            with open(self._snap_path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def append_journal(self, records: Sequence[bytes]) -> None:
        if not records:
            return
        with open(self._journal_path, "ab") as f:
            f.write(b"".join(r + b"\n" for r in records))
            f.flush()
            os.fsync(f.fileno())

    def read_journal(self) -> List[bytes]:
        try:
            with open(self._journal_path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return []
        # NOT splitlines(): a torn final line (crash mid-append) must
        # reach the parser as-is so it is rejected there, and only there.
        lines = data.split(b"\n")
        if lines and lines[-1] == b"":
            lines.pop()
        return lines

    def reset_journal(self, records: Sequence[bytes] = ()) -> None:
        self._replace(
            self._journal_path, b"".join(r + b"\n" for r in records)
        )


class EtcdBackend(PersistBackend):
    """Chunked keys through the shared EtcdGateway.

    Keys under `prefix`:
      meta                -> JSON {"gen": g, "chunks": n, "bytes": total}
      snap/<gen>/<i>      -> snapshot chunk i of generation g
      journal/<seq16>     -> one appended batch of journal lines

    Snapshot switch is atomic at the meta key: readers resolve the
    generation from meta first, so a writer laying down gen g+1 chunks
    never disturbs a reader of gen g; stale generations are deleted
    after the switch (best effort)."""

    def __init__(self, gateway, prefix: str, *,
                 chunk_bytes: int = ETCD_CHUNK_BYTES,
                 timeout: float = 30.0):
        import json as _json

        self._json = _json
        self.gateway = gateway
        self.prefix = prefix.rstrip("/")
        self.chunk_bytes = int(chunk_bytes)
        self.timeout = timeout
        self._journal_seq: Optional[int] = None

    # -- keys -----------------------------------------------------------

    def _meta_key(self) -> str:
        return f"{self.prefix}/meta"

    def _chunk_key(self, gen: int, i: int) -> str:
        return f"{self.prefix}/snap/{gen:08d}/{i:06d}"

    def _journal_key(self, seq: int) -> str:
        return f"{self.prefix}/journal/{seq:016d}"

    # -- snapshot -------------------------------------------------------

    def _read_meta(self) -> Optional[dict]:
        raw = self.gateway.get(self._meta_key(), timeout=self.timeout)
        if raw is None:
            return None
        return self._json.loads(raw.decode())

    def write_snapshot(self, data: bytes) -> None:
        meta = self._read_meta()
        old_gen = int(meta["gen"]) if meta else 0
        gen = old_gen + 1
        chunks = [
            data[i:i + self.chunk_bytes]
            for i in range(0, max(len(data), 1), self.chunk_bytes)
        ]
        for i, chunk in enumerate(chunks):
            self.gateway.put(
                self._chunk_key(gen, i), chunk, timeout=self.timeout
            )
        self.gateway.put(
            self._meta_key(),
            self._json.dumps(
                {"gen": gen, "chunks": len(chunks), "bytes": len(data)}
            ),
            timeout=self.timeout,
        )
        if old_gen:
            try:
                self.gateway.delete_prefix(
                    f"{self.prefix}/snap/{old_gen:08d}/",
                    timeout=self.timeout,
                )
            except Exception:
                pass  # stale chunks are garbage, not corruption

    def read_snapshot(self) -> Optional[bytes]:
        meta = self._read_meta()
        if not meta:
            return None
        gen, n = int(meta["gen"]), int(meta["chunks"])
        parts = []
        for i in range(n):
            chunk = self.gateway.get(
                self._chunk_key(gen, i), timeout=self.timeout
            )
            if chunk is None:
                # A half-deleted or half-written generation: surface as
                # "no snapshot" rather than a torn payload (the decoder
                # would reject the checksum anyway, this is friendlier).
                return None
            parts.append(chunk)
        data = b"".join(parts)
        if len(data) != int(meta.get("bytes", len(data))):
            return None
        return data

    # -- journal --------------------------------------------------------

    def _journal_entries(self) -> List[bytes]:
        pairs = self.gateway.get_prefix(
            f"{self.prefix}/journal/", timeout=self.timeout
        )
        return [v for _, v in sorted(pairs)]

    def _next_seq(self) -> int:
        if self._journal_seq is None:
            pairs = self.gateway.get_prefix(
                f"{self.prefix}/journal/", timeout=self.timeout
            )
            last = max((k for k, _ in pairs), default=None)
            self._journal_seq = (
                int(last.rsplit("/", 1)[1]) if last is not None else 0
            )
        self._journal_seq += 1
        return self._journal_seq

    def append_journal(self, records: Sequence[bytes]) -> None:
        if not records:
            return
        self.gateway.put(
            self._journal_key(self._next_seq()),
            b"\n".join(records),
            timeout=self.timeout,
        )

    def read_journal(self) -> List[bytes]:
        out: List[bytes] = []
        for batch in self._journal_entries():
            out.extend(batch.split(b"\n"))
        return out

    def reset_journal(self, records: Sequence[bytes] = ()) -> None:
        self.gateway.delete_prefix(
            f"{self.prefix}/journal/", timeout=self.timeout
        )
        self._journal_seq = 0
        if records:
            self.append_journal(records)


def parse_backend(
    spec: str,
    *,
    etcd_endpoints: Sequence[str] = (),
    namespace: str = "",
) -> PersistBackend:
    """Build a backend from a `--persist` flag value:
    `file:<directory>` or `etcd:<key-prefix>` (needs --etcd-endpoints).

    `namespace` scopes the snapshot slot and journal under a
    sub-directory / key sub-prefix — the per-shard durability
    namespaces of a federated deployment (every root shard persists
    and warm-restores its own slice; candidates of the SAME shard
    share the namespace, different shards never touch each other's).
    Namespaces must be path/key-safe tokens; the federated flag
    surface passes `shard<N>`."""
    scheme, sep, rest = spec.partition(":")
    if not sep or not rest:
        raise ValueError(
            f"--persist wants file:<dir> or etcd:<prefix>, got {spec!r}"
        )
    if namespace:
        if "/" in namespace or namespace in (".", ".."):
            raise ValueError(
                f"persist namespace must be a single path token, "
                f"got {namespace!r}"
            )
        rest = os.path.join(rest, namespace) if scheme == "file" else (
            rest.rstrip("/") + "/" + namespace
        )
    if scheme == "file":
        return FileBackend(rest)
    if scheme == "etcd":
        if not etcd_endpoints:
            raise ValueError("--persist etcd:... needs --etcd-endpoints")
        from doorman_tpu_torch.server.etcd import EtcdGateway

        return EtcdBackend(EtcdGateway(list(etcd_endpoints)), rest)
    raise ValueError(f"unknown persist backend {scheme!r}")
