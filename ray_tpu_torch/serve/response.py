"""Explicit HTTP responses from deployments.

Parity: returning a starlette ``Response`` from a Serve deployment
(reference: serve/_private/http_util.py Response handling) — full
control over status, content type, and headers instead of the proxy's
default coercion (bytes → octet-stream, str → text, other → JSON).
Picklable (it crosses the replica→proxy boundary as a task result).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Union


class Response:
    def __init__(
        self,
        body: Union[bytes, bytearray, str, Any] = b"",
        *,
        status: int = 200,
        content_type: Optional[str] = None,
        headers: Optional[Dict[str, str]] = None,
    ):
        self.body = body
        self.status = int(status)
        if content_type is None:
            if isinstance(body, (bytes, bytearray, memoryview)):
                content_type = "application/octet-stream"
            elif isinstance(body, str):
                content_type = "text/plain"
            else:
                content_type = "application/json"
        self.content_type = content_type
        self.headers = dict(headers or {})

    def body_bytes(self) -> bytes:
        # memoryview bodies come from the zero-copy payload plane
        # (serve/_private/payloads.py): large bodies arrive as views
        # over the mapped response segment
        if isinstance(self.body, (bytes, bytearray, memoryview)):
            return bytes(self.body)
        if isinstance(self.body, str):
            return self.body.encode()
        return json.dumps(self.body).encode()
