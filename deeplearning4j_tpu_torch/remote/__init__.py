"""JSON over HTTP (port of ``deeplearning4j_tpu/remote``): the
:class:`JsonModelServer`, its :class:`JsonRemoteInference` client and
:class:`RemoteReplica`, a pool replica on another host."""

from .replica import RemoteDeployError, RemoteReplica
from .server import (JsonModelServer, JsonRemoteInference,
                     PartialStreamError, ServiceUnavailableError)

__all__ = ["JsonModelServer", "JsonRemoteInference", "PartialStreamError",
           "RemoteDeployError", "RemoteReplica", "ServiceUnavailableError"]
