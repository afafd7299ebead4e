"""OpenAI-compatible async serving gateway over the continuous runtime (the
JAX package's `serve/gateway`): wire protocol, scheduler bridge, HTTP
server."""
from repro_torch.serve.gateway.bridge import (  # noqa: F401
    RequestHandle, SchedulerBridge,
)
from repro_torch.serve.gateway.protocol import (  # noqa: F401
    ADAPTER_PREFIX, MODEL_BASE, ApiError, encode_chat, encode_text,
    parse_request, prometheus_text,
)
from repro_torch.serve.gateway.server import GatewayServer  # noqa: F401
