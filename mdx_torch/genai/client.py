"""Minimal OpenAI-compatible chat-completions client (stdlib only): the
port's copy of ``mdx/genai/client.py``, which the GenAI agents
(:mod:`mdx_torch.genai.agents`) and the run-scoped chat
(:mod:`mdx_torch.pipeline.chat`) call.

The reference depends on the ``openai-agents`` SDK
(ref pipeline/genai_agents.py:31-43); this deployment has no such
dependency, so the small slice of the protocol the pipeline needs is
implemented directly: chat completions with JSON tool-calling and
JSON-object response format, over ``http.client`` with retries.

The transport is injectable (``set_transport``) so the full agent loop is
testable without network access — tests install a scripted fake transport
(tests/test_genai.py), mirroring how the reference left this seam untested
(SURVEY.md §4 "the untested seam") but fixing it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Optional

DEFAULT_BASE_URL = os.environ.get("OPENAI_BASE_URL",
                                  "https://api.openai.com/v1")

# Models that reject a temperature parameter (ref genai_agents.py:62-75).
_NO_TEMPERATURE_PREFIXES = ("o1", "o3", "o4", "gpt-5")


class LLMError(RuntimeError):
    pass


Transport = Callable[[str, dict], dict]
_transport: Optional[Transport] = None


def set_transport(fn: Optional[Transport]) -> None:
    """Install a transport ``fn(model, payload) -> response_dict`` (tests)."""
    global _transport
    _transport = fn


def _http_transport(model: str, payload: dict) -> dict:
    import http.client
    import urllib.parse

    api_key = os.environ.get("OPENAI_API_KEY", "")
    if not api_key:
        raise LLMError("OPENAI_API_KEY not set")
    url = urllib.parse.urlparse(DEFAULT_BASE_URL + "/chat/completions")
    conn_cls = (http.client.HTTPSConnection if url.scheme == "https"
                else http.client.HTTPConnection)
    body = json.dumps(payload).encode("utf-8")
    last_err: Exception | None = None
    for attempt in range(3):
        try:
            conn = conn_cls(url.netloc, timeout=120)
            conn.request("POST", url.path, body=body, headers={
                "Authorization": f"Bearer {api_key}",
                "Content-Type": "application/json",
            })
            resp = conn.getresponse()
            data = resp.read().decode("utf-8", "replace")
            if resp.status == 429 or resp.status >= 500:
                last_err = LLMError(f"HTTP {resp.status}: {data[:200]}")
                time.sleep(1.5 * (attempt + 1))
                continue
            if resp.status != 200:
                raise LLMError(f"HTTP {resp.status}: {data[:500]}")
            return json.loads(data)
        except LLMError:
            raise
        except Exception as exc:  # network-level failure → retry
            last_err = exc
            time.sleep(1.5 * (attempt + 1))
        finally:
            try:
                conn.close()
            except Exception:
                pass
    raise LLMError(f"transport failed after retries: {last_err}")


def supports_temperature(model: str) -> bool:
    return not any(model.startswith(p) for p in _NO_TEMPERATURE_PREFIXES)


def chat_completion(
    model: str,
    messages: list[dict],
    *,
    tools: list[dict] | None = None,
    temperature: float | None = 0.2,
    json_object: bool = False,
) -> dict:
    """One chat-completions call → the assistant ``message`` dict.

    Returns ``{"content": str|None, "tool_calls": [...]}``.
    """
    payload: dict[str, Any] = {"model": model, "messages": messages}
    if tools:
        payload["tools"] = tools
    if temperature is not None and supports_temperature(model):
        payload["temperature"] = temperature
    if json_object:
        payload["response_format"] = {"type": "json_object"}

    fn = _transport or _http_transport
    resp = fn(model, payload)
    try:
        return resp["choices"][0]["message"]
    except (KeyError, IndexError) as exc:
        raise LLMError(f"malformed completion response: {exc}") from exc


def extract_json(text: str) -> dict:
    """Parse the first JSON object found in a completion's text."""
    text = text.strip()
    if text.startswith("```"):
        text = text.strip("`")
        if text.startswith("json"):
            text = text[4:]
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        start = text.find("{")
        if start < 0:
            raise LLMError("no JSON object in model output")
        depth = 0
        for i in range(start, len(text)):
            if text[i] == "{":
                depth += 1
            elif text[i] == "}":
                depth -= 1
                if depth == 0:
                    return json.loads(text[start:i + 1])
        raise LLMError("unbalanced JSON in model output")
