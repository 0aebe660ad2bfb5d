"""Streaming lease-push messages: WatchCapacityRequest / Response.

The build image has protoc but no gRPC python codegen plugin, and no
protoc wrapper importable from Python, so these descriptors are built
PROGRAMMATICALLY at import time instead of from a checked-in serialized
blob: a `FileDescriptorProto` for `doorman_stream.proto` (importing the
base `doorman.proto` types — ResourceRequest, ResourceResponse,
Mastership) is registered in the default descriptor pool and the
message classes come from `message_factory`. The message set mirrors
the .proto text appended to doorman.proto; keep the two in sync.

Wire contract (doc/streaming.md):

  WatchCapacityRequest — one per stream, at establishment:
    client_id   the subscribing client
    resource    the subscriptions (same shape as GetCapacity lines:
                resource_id, priority, wants, and the current lease as
                `has` — the resume baseline on reconnect)
    resume_seq  last seq the client observed (0 = fresh subscription:
                the first message snapshots every subscribed resource)

  WatchCapacityResponse — pushed at tick edges:
    seq         monotonic per master: the persist journal's sequence
                number when persistence is configured, else a registry
                counter. Clients ignore messages with seq <= the last
                seq they applied (exactly-once), and offer the last
                seen seq back as resume_seq on reconnect.
    tick        the server tick that produced this delta
    response    ONLY the rows whose lease moved (byte-identical to what
                a GetCapacity poll at the same instant would carry)
    mastership  set => terminal: this server stopped serving the stream
                (mastership lost / shutting down); reconnect to
                master_address (empty = master unknown, back off)
    snapshot    true on a stream's first message: `response` baselines
                every subscribed resource that differs from the
                client's offered `has` (all of them when resume_seq=0)
"""

from __future__ import annotations

from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

# Registering doorman.proto in the default pool is a side effect of this
# import; the stream file depends on its types.
from doorman_tpu_torch.proto import doorman_pb2  # noqa: F401

__all__ = ["WatchCapacityRequest", "WatchCapacityResponse"]

_FILE = "doorman_stream.proto"
_F = descriptor_pb2.FieldDescriptorProto


def _add_field(msg, name, number, ftype, *, type_name=None, repeated=False):
    f = msg.field.add()
    f.name = name
    f.number = number
    f.type = ftype
    f.label = _F.LABEL_REPEATED if repeated else _F.LABEL_OPTIONAL
    if type_name:
        f.type_name = type_name
    return f


def _file_descriptor_proto() -> descriptor_pb2.FileDescriptorProto:
    fd = descriptor_pb2.FileDescriptorProto()
    fd.name = _FILE
    fd.package = "doorman_tpu"
    fd.syntax = "proto3"
    fd.dependency.append("doorman.proto")

    req = fd.message_type.add()
    req.name = "WatchCapacityRequest"
    _add_field(req, "client_id", 1, _F.TYPE_STRING)
    _add_field(req, "resource", 2, _F.TYPE_MESSAGE,
               type_name=".doorman_tpu.ResourceRequest", repeated=True)
    _add_field(req, "resume_seq", 3, _F.TYPE_INT64)

    resp = fd.message_type.add()
    resp.name = "WatchCapacityResponse"
    _add_field(resp, "seq", 1, _F.TYPE_INT64)
    _add_field(resp, "tick", 2, _F.TYPE_INT64)
    _add_field(resp, "response", 3, _F.TYPE_MESSAGE,
               type_name=".doorman_tpu.ResourceResponse", repeated=True)
    _add_field(resp, "mastership", 4, _F.TYPE_MESSAGE,
               type_name=".doorman_tpu.Mastership")
    _add_field(resp, "snapshot", 5, _F.TYPE_BOOL)
    return fd


_pool = descriptor_pool.Default()
try:
    _file = _pool.FindFileByName(_FILE)
except KeyError:
    _file = _pool.Add(_file_descriptor_proto())

WatchCapacityRequest = message_factory.GetMessageClass(
    _file.message_types_by_name["WatchCapacityRequest"]
)
WatchCapacityResponse = message_factory.GetMessageClass(
    _file.message_types_by_name["WatchCapacityResponse"]
)
