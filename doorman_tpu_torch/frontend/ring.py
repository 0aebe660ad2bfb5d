"""The shared-memory push ring: seq-stamped, checksummed frames from
one writer (the device-owning tick process) to per-worker readers.

Layout: a 32-byte control block, then `capacity` data bytes.

    control:  <version:u64><write_pos:u64><frames:u64><pad:u64>
    frame:    <magic:u32><shard:u16><kind:u8><flags:u8>
              <length:u32><stream_id:u64><seq:u64><crc:u32>
              <payload: length bytes>      (all little-endian)

The control block is a seqlock: Python writes it as a multi-byte
memcpy over shared memory, which is NOT atomic across processes, so a
reader could otherwise observe a torn `write_pos` mid-update — garbage
that would trigger a spurious lap and a mass stream reset. The writer
bumps `version` to odd before touching the fields and to even after;
a reader retries until it sees the same even version on both sides of
its copy, so every control read is a consistent snapshot.

`write_pos` is the writer's LOGICAL position — total bytes ever
appended, never wrapped; the physical offset of any logical position is
`pos % capacity`, and a frame whose bytes straddle the physical end is
written (and read) as two slices. The writer publishes `write_pos`
only AFTER the frame's bytes are fully in place, so a reader that
stays within `[its cursor, write_pos)` can never observe a frame the
writer is still composing. Two failure shapes remain, and both are
detected rather than trusted away:

  * torn / corrupt bytes — a writer that died mid-frame before
    publishing leaves garbage past `write_pos` (never read), but a
    reader lapped DURING its copy can see a frame overwritten under
    it: the crc32 (over header-sans-crc + payload) and the magic
    reject it, and the reader resyncs to `write_pos`;
  * lapping — `write_pos - cursor > capacity` means the writer
    overwrote bytes the reader never consumed. The reader reports
    `lapped`, resyncs to `write_pos`, and its owner resets the
    affected streams to a redirect (clients resume from their
    has-baseline; doc/streaming.md) — a lap is therefore loud,
    never a silent gap.

Frame seqs are the writer's monotonic frame counter (distinct from the
push seq INSIDE a payload, which is the StreamShard's per-stream
contract): a reader checks continuity per ring, so any skipped frame —
however it was skipped — surfaces as `gap` instead of silence.

The buffer is either a `multiprocessing.shared_memory.SharedMemory`
block (real worker processes) or a plain bytearray (the inline pool:
tests, chaos, the workload harness) — the writer and reader only ever
see a memoryview, so every byte of framing logic is identical, which
is what lets the tier-1 suite pin the cross-process contract without
spawning processes.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, NamedTuple, Optional

__all__ = [
    "Frame",
    "KIND_BEAT",
    "KIND_PUSH",
    "KIND_TERMINAL",
    "Ring",
    "RingReader",
    "RingWriter",
]

MAGIC = 0x52494E47  # "RING"

# Frame kinds. PUSH payloads are pre-serialized WatchCapacityResponse
# bytes handed to gRPC as-is; TERMINAL payloads are the serialized
# terminal redirect — the worker sends the bytes and then ENDS the
# stream (the in-process handler's message-object contract, expressed
# as a frame flag the pump can act on). BEAT is the writer's liveness
# tick: an empty frame per push edge, so a worker's deadline wheel can
# tell "quiet tick" from "stalled ring" without parsing payloads.
KIND_PUSH = 1
KIND_TERMINAL = 2
KIND_BEAT = 3

_CTRL_VER = struct.Struct("<Q")
_CTRL_FIELDS = struct.Struct("<QQ")
_HEAD = struct.Struct("<IHBBIQQI")
CTRL_SIZE = 32  # version + write_pos + frames, padded
HEADER_SIZE = _HEAD.size  # 32
_MASK64 = (1 << 64) - 1


class Frame(NamedTuple):
    seq: int
    shard: int
    kind: int
    stream_id: int
    payload: bytes


class Ring:
    """One ring's buffer: control block + data region over either a
    plain bytearray (inline) or a named SharedMemory block."""

    def __init__(self, capacity: int, *, buf=None, shm=None):
        if capacity < HEADER_SIZE * 2:
            raise ValueError(f"ring capacity {capacity} too small")
        self.capacity = int(capacity)
        self._shm = shm
        if buf is None:
            buf = bytearray(CTRL_SIZE + self.capacity)
        self.buf = memoryview(buf)
        if len(self.buf) < CTRL_SIZE + self.capacity:
            raise ValueError("buffer smaller than control + capacity")

    @classmethod
    def in_memory(cls, capacity: int) -> "Ring":
        return cls(capacity)

    @classmethod
    def shared(cls, name: str, capacity: int, *,
               create: bool = False, track: bool = True) -> "Ring":
        """A ring over a named shared-memory block (real worker
        processes). The creator owns unlink(); attachers only close.
        `track=False` takes an attached block off this process's
        resource tracker, which would otherwise unlink it when the
        process exits: a listener worker started as a fresh interpreter
        has a tracker of its own, and the ring must outlive the worker
        (the respawn reads it)."""
        from multiprocessing import resource_tracker, shared_memory

        if create:
            shm = shared_memory.SharedMemory(
                name=name, create=True, size=CTRL_SIZE + capacity
            )
            shm.buf[:CTRL_SIZE] = b"\x00" * CTRL_SIZE
        else:
            shm = shared_memory.SharedMemory(name=name)
            if not track:
                resource_tracker.unregister(shm._name, "shared_memory")
        return cls(capacity, buf=shm.buf, shm=shm)

    @property
    def name(self) -> Optional[str]:
        return self._shm.name if self._shm is not None else None

    # -- control block -------------------------------------------------

    def read_control(self) -> tuple:
        """Seqlock read: retry until the version is even (no update in
        flight) and unchanged across the field copy (module
        docstring)."""
        for _ in range(64):
            v1 = _CTRL_VER.unpack_from(self.buf, 0)[0]
            fields = _CTRL_FIELDS.unpack_from(self.buf, 8)
            if v1 & 1:
                continue
            if _CTRL_VER.unpack_from(self.buf, 0)[0] == v1:
                return fields
        # Only reachable if the writer died MID-update (an odd version
        # that never clears): surface the last copy — the crc and lap
        # checks downstream keep a torn value loud, not silent.
        return fields

    def write_control(self, write_pos: int, frames: int) -> None:
        v = _CTRL_VER.unpack_from(self.buf, 0)[0]
        _CTRL_VER.pack_into(self.buf, 0, (v + 1) & _MASK64)  # odd: busy
        _CTRL_FIELDS.pack_into(self.buf, 8, write_pos, frames)
        _CTRL_VER.pack_into(self.buf, 0, (v + 2) & _MASK64)  # published

    # -- wrapped data access -------------------------------------------

    def write_at(self, pos: int, data: bytes) -> None:
        """Write `data` at logical `pos`, splitting across the physical
        end when the frame straddles it."""
        off = pos % self.capacity
        first = min(len(data), self.capacity - off)
        base = CTRL_SIZE
        self.buf[base + off:base + off + first] = data[:first]
        if first < len(data):
            self.buf[base:base + len(data) - first] = data[first:]

    def read_at(self, pos: int, n: int) -> bytes:
        off = pos % self.capacity
        first = min(n, self.capacity - off)
        base = CTRL_SIZE
        out = bytes(self.buf[base + off:base + off + first])
        if first < n:
            out += bytes(self.buf[base:base + (n - first)])
        return out

    def close(self) -> None:
        # A memoryview over SharedMemory must be released before the
        # block can close; the plain-bytearray path just drops it.
        self.buf.release()
        if self._shm is not None:
            self._shm.close()

    def unlink(self) -> None:
        if self._shm is not None:
            try:
                self._shm.unlink()
            except FileNotFoundError:  # pragma: no cover - double unlink
                pass


def _crc(head_sans_crc: bytes, payload: bytes) -> int:
    return zlib.crc32(payload, zlib.crc32(head_sans_crc)) & 0xFFFFFFFF


class RingWriter:
    """The single writer. Appends never block and never fail for a slow
    reader: the ring overwrites oldest bytes and the lapped reader
    detects it (module docstring) — backpressure is the READER's reset
    contract, not the tick edge's problem."""

    def __init__(self, ring: Ring):
        self.ring = ring
        write_pos, frames = ring.read_control()
        self.write_pos = int(write_pos)
        self.seq = int(frames)
        self.frames = int(frames)
        self.bytes_written = 0

    def append(self, shard: int, kind: int, stream_id: int,
               payload: bytes = b"") -> int:
        total = HEADER_SIZE + len(payload)
        if total > self.ring.capacity - HEADER_SIZE:
            raise ValueError(
                f"frame of {total} bytes exceeds ring capacity "
                f"{self.ring.capacity}"
            )
        self.seq += 1
        head_sans_crc = _HEAD.pack(
            MAGIC, shard, kind, 0, len(payload), stream_id, self.seq, 0
        )[:-4]
        crc = _crc(head_sans_crc, payload)
        head = head_sans_crc + struct.pack("<I", crc)
        self.ring.write_at(self.write_pos, head)
        if payload:
            self.ring.write_at(self.write_pos + HEADER_SIZE, payload)
        self.write_pos += total
        self.frames += 1
        self.bytes_written += total
        # Publish AFTER the frame bytes are in place (module docstring).
        self.ring.write_control(self.write_pos, self.frames)
        return self.seq


class PollResult(NamedTuple):
    frames: List[Frame]
    lapped: bool
    corrupt: int
    gap: int


class RingReader:
    """One reader's cursor over a ring. A fresh reader starts at the
    CURRENT write position (a restarted worker must not replay frames
    addressed to streams it no longer holds — resume rides the push-seq
    contract, not ring replay)."""

    def __init__(self, ring: Ring):
        self.ring = ring
        write_pos, frames = ring.read_control()
        self.pos = int(write_pos)
        self.next_seq = int(frames) + 1
        self.frames_read = 0
        self.laps = 0
        self.corrupt_total = 0

    def poll(self, max_frames: int = 0) -> PollResult:
        """Drain complete frames between the cursor and the published
        write position. Corrupt bytes or a lap resync the cursor to the
        write position and are REPORTED (the caller resets streams);
        `gap` counts frame seqs skipped by a resync."""
        frames: List[Frame] = []
        lapped = False
        corrupt = 0
        gap = 0
        write_pos, wframes = self.ring.read_control()
        if write_pos - self.pos > self.ring.capacity:
            lapped = True
            self.laps += 1
            gap += max(int(wframes) + 1 - self.next_seq, 0)
            self.pos = int(write_pos)
            self.next_seq = int(wframes) + 1
            return PollResult(frames, lapped, corrupt, gap)
        while self.pos < write_pos:
            if max_frames and len(frames) >= max_frames:
                break
            head = self.ring.read_at(self.pos, HEADER_SIZE)
            magic, shard, kind, _flags, length, stream_id, seq, crc = (
                _HEAD.unpack(head)
            )
            ok = (
                magic == MAGIC
                and self.pos + HEADER_SIZE + length <= write_pos
            )
            payload = b""
            if ok:
                payload = self.ring.read_at(
                    self.pos + HEADER_SIZE, length
                )
                ok = _crc(head[:-4], payload) == crc
            # Re-check the control block: the writer may have lapped us
            # between reading write_pos and copying the bytes — the crc
            # usually catches it, but a full frame overwritten by
            # another full frame at the same offset needs the position
            # check to stay honest.
            if ok:
                now_pos, _ = self.ring.read_control()
                if now_pos - self.pos > self.ring.capacity:
                    ok = False
            if not ok:
                corrupt += 1
                self.corrupt_total += 1
                now_pos, now_frames = self.ring.read_control()
                gap += max(int(now_frames) + 1 - self.next_seq, 0)
                self.pos = int(now_pos)
                self.next_seq = int(now_frames) + 1
                break
            if seq != self.next_seq:
                gap += max(seq - self.next_seq, 0)
            frames.append(Frame(seq, shard, kind, stream_id, payload))
            self.frames_read += 1
            self.next_seq = seq + 1
            self.pos += HEADER_SIZE + length
        return PollResult(frames, lapped, corrupt, gap)

    def status(self) -> dict:
        write_pos, frames = self.ring.read_control()
        return {
            "cursor": self.pos,
            "write_pos": int(write_pos),
            "backlog_bytes": int(write_pos) - self.pos,
            "frames_read": self.frames_read,
            "laps": self.laps,
            "corrupt": self.corrupt_total,
        }
