"""Wire protocol: generated protobuf classes + gRPC service wiring.

`doorman_pb2` is generated from `doorman.proto` by protoc (checked in so the
package imports without a protoc step); regenerate with:

    protoc --python_out=doorman_tpu/proto -I doorman_tpu/proto \
        doorman_tpu/proto/doorman.proto
"""

from doorman_tpu_torch.proto import doorman_pb2  # noqa: F401
