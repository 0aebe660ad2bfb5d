"""Hand-wired gRPC service definition for the Capacity service.

The build image has protoc but not the gRPC python codegen plugin, so the
service stubs/handlers that `grpc_python_plugin` would emit are written by
hand here. The method set mirrors the reference service
(reference proto/doorman/doorman.proto:210-224): Discovery,
GetCapacity, GetServerCapacity, ReleaseCapacity.

Works with both `grpc` (sync) and `grpc.aio` channels/servers: the stub just
binds serializers to method paths, and `add_capacity_servicer` registers a
generic handler, which both server flavors accept.
"""

from __future__ import annotations

import grpc

from doorman_tpu_torch.proto import doorman_pb2 as pb
from doorman_tpu_torch.proto import doorman_stream_pb2 as spb

SERVICE_NAME = "doorman_tpu.Capacity"

# method name -> (request class, response class)
_METHODS = {
    "Discovery": (pb.DiscoveryRequest, pb.DiscoveryResponse),
    "GetCapacity": (pb.GetCapacityRequest, pb.GetCapacityResponse),
    "GetServerCapacity": (pb.GetServerCapacityRequest, pb.GetServerCapacityResponse),
    "ReleaseCapacity": (pb.ReleaseCapacityRequest, pb.ReleaseCapacityResponse),
}

# Server-streaming methods (unary request, response stream).
_STREAM_METHODS = {
    "WatchCapacity": (spb.WatchCapacityRequest, spb.WatchCapacityResponse),
}


def _stream_response_serializer(msg) -> bytes:
    """Stream responses may arrive pre-serialized: the fanout assembles
    push messages as bytes (serialized header + framed row chunks, each
    hot row serialized once per shard per tick — server/streams.py) and
    they go on the wire as-is; message objects (terminal redirects, the
    chaos proxy's forwarded pushes) serialize normally."""
    if isinstance(msg, (bytes, bytearray, memoryview)):
        return bytes(msg)
    return msg.SerializeToString()


class CapacityStub:
    """Client-side stub; `channel` may be a sync or aio grpc channel."""

    def __init__(self, channel):
        for name, (req_cls, resp_cls) in _METHODS.items():
            setattr(
                self,
                name,
                channel.unary_unary(
                    f"/{SERVICE_NAME}/{name}",
                    request_serializer=req_cls.SerializeToString,
                    response_deserializer=resp_cls.FromString,
                ),
            )
        for name, (req_cls, resp_cls) in _STREAM_METHODS.items():
            setattr(
                self,
                name,
                channel.unary_stream(
                    f"/{SERVICE_NAME}/{name}",
                    request_serializer=req_cls.SerializeToString,
                    response_deserializer=resp_cls.FromString,
                ),
            )


class CapacityServicer:
    """Base servicer; subclass and override the methods.

    Methods may be plain functions (sync server) or coroutines (aio
    server); WatchCapacity is server-streaming — an (async) generator
    yielding WatchCapacityResponse messages.
    """

    def Discovery(self, request, context):
        raise NotImplementedError

    def GetCapacity(self, request, context):
        raise NotImplementedError

    def GetServerCapacity(self, request, context):
        raise NotImplementedError

    def ReleaseCapacity(self, request, context):
        raise NotImplementedError

    def WatchCapacity(self, request, context):
        raise NotImplementedError


def add_capacity_servicer(server, servicer: CapacityServicer) -> None:
    """Register `servicer` on a grpc or grpc.aio server."""
    handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            getattr(servicer, name),
            request_deserializer=req_cls.FromString,
            response_serializer=resp_cls.SerializeToString,
        )
        for name, (req_cls, resp_cls) in _METHODS.items()
    }
    for name, (req_cls, resp_cls) in _STREAM_METHODS.items():
        handlers[name] = grpc.unary_stream_rpc_method_handler(
            getattr(servicer, name),
            request_deserializer=req_cls.FromString,
            response_serializer=_stream_response_serializer,
        )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),)
    )
