"""The port's copy of the generated protobuf module (``protoc --python_out``
of ``proto/herdsman.proto``), byte for byte the JAX package's.

Import it by its package path only::

    from herdsman_tpu_torch.service._proto import herdsman_pb2

never as a top-level ``herdsman_pb2`` through ``sys.path``: in a process
that has imported the JAX package's copy, that name is the JAX package's
file.  Both copies register the same ``herdsman.proto`` in protobuf's
default descriptor pool, which takes a second registration only when its
serialized descriptor is byte-identical, so the schema is not edited here.

Regenerate with ``python -m herdsman_tpu_torch.service.proto_build``.
"""

# The wire's message cap and the channel options that set it, shared by the
# server, the client and the worker fleet (reference src/main.cpp:135-136,
# grpc_worker_group.cpp:23-24).
MAX_MESSAGE_BYTES = 32 * 1024 * 1024
CHANNEL_OPTIONS = (
    ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
    ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
)
