"""OpenAI-compatible wire protocol for the serving gateway (a copy of the
JAX package's `serve/gateway/protocol.py`): request validation, model-name
-> adapter routing, token <-> text mapping, response/SSE framing, and the
Prometheus text exposition.

Everything here is pure host-side data plumbing — no torch, no I/O — so the
HTTP server (server.py), its clients and the tests all speak exactly the
same dialect.

Model-name routing convention: the `model` field selects the tenant.
`"base"` (or the engine's architecture name) runs the bare merged base;
`"adapter:<id>"` routes through the AdapterBank row of tenant `<id>`,
loaded from its adapter-only checkpoint at admission when not resident.
FourierFT's ~0.064M-parameter tenants are why per-request routing by name
is viable at scale — a tenant is one tiny bank row, not a model copy.

Tokens vs text: the repo has no external tokenizer (and must not grow the
dependency), so text prompts go through a deterministic byte-level
encoding (`encode_text`: UTF-8 byte folded into the model vocab) and
`/v1/completions` additionally accepts the prompt as a raw token-id array
— the exactness-friendly path the replay checks use.
Every emitted chunk carries its `token_id` and non-streaming responses a
`token_ids` list (extension fields), so clients can compare streams
bit-for-bit without depending on the text mapping.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional

# torch-free by design (serve/tiering/config.py): the priority classes the
# `priority` request extension accepts
from repro_torch.serve.tiering.config import DEFAULT_PRIORITY, PRIORITIES

MODEL_BASE = "base"
ADAPTER_PREFIX = "adapter:"
CHAT_ROLES = ("system", "user", "assistant", "tool")


class ApiError(Exception):
    """An HTTP-mappable request failure, serialized OpenAI-style:
    {"error": {"message", "type", "code"}}."""

    def __init__(self, status: int, message: str,
                 err_type: str = "invalid_request_error",
                 code: Optional[str] = None):
        super().__init__(message)
        self.status = status
        self.err_type = err_type
        self.code = code

    def body(self) -> Dict:
        return {"error": {"message": str(self), "type": self.err_type,
                          "code": self.code}}


def resolve_model(name, base_aliases=()) -> Optional[str]:
    """Model name -> adapter id (None = bare base). 404 on anything that is
    neither the base nor an `adapter:<id>` name — existence/residency of
    the id itself is the gateway's (bank-side) check, not ours."""
    if not isinstance(name, str) or not name:
        raise ApiError(400, "'model' must be a non-empty string")
    if name == MODEL_BASE or name in base_aliases:
        return None
    if name.startswith(ADAPTER_PREFIX):
        aid = name[len(ADAPTER_PREFIX):]
        if not aid:
            raise ApiError(400, "empty adapter id in 'model'")
        return aid
    raise ApiError(404, f"model {name!r} does not exist; use "
                        f"{MODEL_BASE!r} or '{ADAPTER_PREFIX}<id>'",
                   err_type="not_found_error", code="model_not_found")


# ---- token <-> text ---------------------------------------------------------
def encode_text(text: str, vocab: int) -> List[int]:
    """Deterministic byte-level encoding: UTF-8 byte folded into the model
    vocab. Not a linguistic tokenizer — a stable, dependency-free mapping
    every component (gateway, clients, replay check) shares."""
    return [b % vocab for b in text.encode("utf-8")]


def encode_chat(messages: List[Dict], vocab: int) -> List[int]:
    """ChatML-ish serialization of a message list, ending with the
    assistant header the completion notionally continues."""
    parts = [f"<{m['role']}>{m['content']}" for m in messages]
    parts.append("<assistant>")
    return encode_text("\n".join(parts), vocab)


def decode_token(tok: int) -> str:
    """Printable-ASCII bytes round-trip; everything else renders as a
    <id> placeholder (the byte-level mapping is not invertible once vocab
    folding or non-ASCII input is involved — `token_id` is the ground
    truth, text is a human courtesy)."""
    return chr(tok) if 32 <= tok < 127 else f"<{tok}>"


# ---- request parsing --------------------------------------------------------
@dataclass
class ParsedRequest:
    kind: str                      # "chat" | "completion"
    model: str                     # verbatim model name (echoed back)
    adapter_id: Optional[str]      # routed tenant (None = base)
    prompt: List[int]              # token ids
    max_new: int
    stream: bool
    priority: str = DEFAULT_PRIORITY   # extension: tiering class
                                       # (interactive|batch|best_effort)


def _require(cond: bool, message: str, status: int = 400) -> None:
    if not cond:
        raise ApiError(status, message)


def _parse_prompt_tokens(prompt, vocab: int) -> List[int]:
    if isinstance(prompt, str):
        return encode_text(prompt, vocab)
    _require(isinstance(prompt, list) and len(prompt) > 0,
             "'prompt' must be a non-empty string or token-id array")
    _require(all(isinstance(t, int) and not isinstance(t, bool)
                 for t in prompt),
             "'prompt' array must contain integer token ids")
    bad = [t for t in prompt if not 0 <= t < vocab]
    _require(not bad, f"prompt token ids {bad[:3]} outside the model "
                      f"vocab [0, {vocab})")
    return list(prompt)


def parse_request(kind: str, payload, *, vocab: int, max_len: int,
                  default_max_new: int = 16,
                  base_aliases=()) -> ParsedRequest:
    """Validate one /v1/chat/completions ("chat") or /v1/completions
    ("completion") body into a ParsedRequest; raises ApiError (400/404)
    on anything malformed. Decoding is greedy-only: sampling knobs are
    accepted and ignored (OpenAI-client pragmatism), but parameters that
    change the response SHAPE (n, best_of) must be absent or 1."""
    _require(isinstance(payload, dict), "request body must be a JSON object")
    adapter_id = resolve_model(payload.get("model"), base_aliases)
    if kind == "chat":
        messages = payload.get("messages")
        _require(isinstance(messages, list) and len(messages) > 0,
                 "'messages' must be a non-empty array")
        for m in messages:
            _require(isinstance(m, dict)
                     and isinstance(m.get("role"), str)
                     and isinstance(m.get("content"), str),
                     "each message needs string 'role' and 'content'")
            _require(m["role"] in CHAT_ROLES,
                     f"unknown message role {m['role']!r}; "
                     f"one of {CHAT_ROLES}")
        prompt = encode_chat(messages, vocab)
        max_new = payload.get("max_completion_tokens",
                              payload.get("max_tokens", default_max_new))
    else:
        _require("prompt" in payload, "'prompt' is required")
        prompt = _parse_prompt_tokens(payload["prompt"], vocab)
        max_new = payload.get("max_tokens", default_max_new)
    _require(len(prompt) >= 1, "prompt encodes to zero tokens")
    _require(isinstance(max_new, int) and not isinstance(max_new, bool)
             and max_new >= 1, "'max_tokens' must be an integer >= 1")
    stream = payload.get("stream", False)
    _require(isinstance(stream, bool), "'stream' must be a boolean")
    priority = payload.get("priority", DEFAULT_PRIORITY)
    _require(isinstance(priority, str) and priority in PRIORITIES,
             f"'priority' must be one of {list(PRIORITIES)}")
    for knob in ("n", "best_of"):
        _require(payload.get(knob, 1) == 1,
                 f"'{knob}' != 1 is not supported (greedy decoding "
                 "emits exactly one choice)")
    # same capacity invariant as the scheduler (slots.py): the last
    # generated token is never written, so the deepest cache position is
    # len(prompt) + max_new - 1
    need = len(prompt) + max_new - 1
    _require(need <= max_len,
             f"prompt ({len(prompt)} tokens) + max_tokens ({max_new}) "
             f"needs {need} cache positions, exceeding the server's "
             f"context window ({max_len})", status=400)
    return ParsedRequest(kind=kind, model=payload["model"],
                         adapter_id=adapter_id, prompt=prompt,
                         max_new=max_new, stream=stream,
                         priority=priority)


# ---- response framing -------------------------------------------------------
def finish_reason(tokens: List[int], eos_id: Optional[int],
                  cancelled: bool = False) -> str:
    if cancelled:
        return "cancelled"
    if eos_id is not None and tokens and tokens[-1] == eos_id:
        return "stop"
    return "length"


def completion_body(req: ParsedRequest, rid: str, created: int,
                    tokens: List[int], reason: str) -> Dict:
    """Non-streaming response JSON for either endpoint."""
    text = "".join(decode_token(t) for t in tokens)
    usage = {"prompt_tokens": len(req.prompt),
             "completion_tokens": len(tokens),
             "total_tokens": len(req.prompt) + len(tokens)}
    if req.kind == "chat":
        choice = {"index": 0, "finish_reason": reason,
                  "message": {"role": "assistant", "content": text}}
        obj = "chat.completion"
    else:
        choice = {"index": 0, "finish_reason": reason, "text": text}
        obj = "text_completion"
    choice["token_ids"] = list(tokens)         # extension: exactness checks
    return {"id": rid, "object": obj, "created": created,
            "model": req.model, "choices": [choice], "usage": usage}


def stream_chunk(req: ParsedRequest, rid: str, created: int,
                 token_id: Optional[int], first: bool,
                 reason: Optional[str] = None) -> Dict:
    """One SSE chunk: a token delta (token_id set) or the final
    finish_reason-only chunk (token_id None)."""
    if req.kind == "chat":
        delta: Dict = {}
        if token_id is not None:
            if first:
                delta["role"] = "assistant"
            delta["content"] = decode_token(token_id)
        choice = {"index": 0, "delta": delta, "finish_reason": reason}
        obj = "chat.completion.chunk"
    else:
        choice = {"index": 0, "finish_reason": reason,
                  "text": decode_token(token_id)
                  if token_id is not None else ""}
        obj = "text_completion"
    if token_id is not None:
        choice["token_id"] = int(token_id)     # extension: exactness checks
    return {"id": rid, "object": obj, "created": created,
            "model": req.model, "choices": [choice]}


def sse_event(payload) -> bytes:
    """`data: <json>\\n\\n` framing; pass the string "[DONE]" verbatim for
    the terminal sentinel."""
    data = payload if isinstance(payload, str) \
        else json.dumps(payload, separators=(",", ":"))
    return b"data: " + data.encode("utf-8") + b"\n\n"


# ---- metrics exposition -----------------------------------------------------
def prometheus_text(values: Dict[str, float], prefix: str = "repro",
                    labeled: Optional[Dict[str, Dict[str, float]]] = None) \
        -> str:
    """Prometheus text exposition of a flat summary dict: keys ending
    `_total` are counters, everything else gauges. `labeled` adds families
    with one label, e.g. {"gateway_responses_total": {'code="200"': 3}}."""
    lines = []
    for key in sorted(values):
        val = values[key]
        if not isinstance(val, (int, float)):
            continue
        name = f"{prefix}_{key}"
        kind = "counter" if key.endswith("_total") else "gauge"
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name} {float(val):.10g}")
    for key in sorted(labeled or ()):
        name = f"{prefix}_{key}"
        kind = "counter" if key.endswith("_total") else "gauge"
        lines.append(f"# TYPE {name} {kind}")
        for label, val in sorted(labeled[key].items()):
            lines.append(f"{name}{{{label}}} {float(val):.10g}")
    return "\n".join(lines) + "\n"
