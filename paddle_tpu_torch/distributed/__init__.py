"""Distributed runtime of the port: the typed-frame transport, the RPC
client and the host ops of the sharded embedding engine."""

from .rpc import RPCClient, RetryPolicy  # noqa: F401
from . import host_ops  # noqa: F401
