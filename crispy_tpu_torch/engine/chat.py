"""LLM chat over transcripts: OpenAI-compatible streaming.

The port's copy of ``crispy_tpu/engine/chat.py`` (host only).

Rebuild of the reference's chat surface (commands/transcription.rs:596-734):
the system prompt embeds the full transcription, history replays as
user/assistant turns, deltas stream per chat id over the event bus as
`transcription-chat-stream`, terminated by `-done` or `-error`.

Transport is a plain SSE request against the configured endpoint (the
async-openai analog, stdlib-only).
"""

from __future__ import annotations

import json
import threading
import urllib.request
from typing import Dict, List

from ..api.events import BUS, EventBus
from ..utils import settings as settings_mod
from .transcription import load_transcription_result

SYSTEM_PROMPT = (
    "You are a helpful assistant. The user has a transcription:\n\n{}\n\n"
    "Answer questions about it."
)


def do_stream_chat(
    recording_path: str,
    messages: List[Dict[str, str]],
    chat_id: str,
    bus: EventBus = BUS,
    settings_root=None,
) -> None:
    """Blocking SSE stream; emits delta events (commands/transcription.rs:658-734)."""
    llm = settings_mod.load_llm_settings(settings_root)
    if not llm.api_key:
        raise ValueError("API key not configured. Set it in Settings.")
    transcription = load_transcription_result(recording_path) or "(No transcription)"

    chat_messages = [{"role": "system", "content": SYSTEM_PROMPT.format(transcription)}]
    for m in messages:
        if m.get("role") in ("user", "assistant"):
            chat_messages.append({"role": m["role"], "content": m.get("content", "")})

    body = json.dumps({
        "model": llm.model,
        "messages": chat_messages,
        "stream": True,
    }).encode("utf-8")
    endpoint = llm.endpoint.rstrip("/")
    req = urllib.request.Request(
        f"{endpoint}/chat/completions",
        data=body,
        headers={
            "Content-Type": "application/json",
            "Authorization": f"Bearer {llm.api_key}",
        },
    )
    # socket timeout: a stalled endpoint must surface as a
    # transcription-chat-error, not hang the worker forever with the UI
    # spinner never resolving
    with urllib.request.urlopen(req, timeout=120) as resp:
        for raw in resp:
            line = raw.decode("utf-8", errors="replace").strip()
            if not line.startswith("data:"):
                continue
            payload = line[5:].strip()
            if payload == "[DONE]":
                break
            try:
                obj = json.loads(payload)
            except json.JSONDecodeError:
                continue
            for choice in obj.get("choices", []):
                delta = (choice.get("delta") or {}).get("content")
                if delta:
                    bus.emit("transcription-chat-stream",
                             {"chat_id": chat_id, "delta": delta})
    bus.emit("transcription-chat-done", {"chat_id": chat_id})


def stream_transcription_chat(
    recording_path: str,
    messages: List[Dict[str, str]],
    chat_id: str,
    bus: EventBus = BUS,
    settings_root=None,
) -> threading.Thread:
    """Fire-and-forget worker (the tokio::spawn analog); errors surface as
    `transcription-chat-error` events."""

    def run():
        try:
            do_stream_chat(recording_path, messages, chat_id, bus, settings_root)
        except Exception as e:
            bus.emit("transcription-chat-error",
                     {"chat_id": chat_id, "delta": f"Error: {e}"})

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t
