"""Generated V2 gRPC protocol messages (``protos/grpc_predict_v2.proto``)
and the generation service's (``protos/kfs_generate.proto``).

Both modules are produced by protoc from the repository's ``protos/``;
regenerate with:

    protoc --python_out=kfserving_tpu_torch/protocol/grpc \
        --proto_path=protos grpc_predict_v2.proto kfs_generate.proto

They are generated from the same files as any other package's copy, so
the two register one descriptor in protobuf's default pool and import
side by side; a copy generated from edited protos would be refused.
"""

from kfserving_tpu_torch.protocol.grpc import grpc_predict_v2_pb2 as pb2

__all__ = ["pb2"]
