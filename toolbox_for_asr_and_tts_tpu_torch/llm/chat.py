"""Conversational LLM client (reference `myLLM.py` equivalent).

Copy of `toolbox_for_asr_and_tts_tpu/llm/chat.py` for the port
(framework-free; imports kept relative).

`correct_text` (non-streaming, myLLM.py:7-42) and `chat_with_qwen`
(streaming, myLLM.py:59-100) against any OpenAI-compatible endpoint,
env-configured (LLM_BASE_URL / LLM_MODEL / LLM_API_KEY — no checked-in
keys). Used by the full_voice_demo loop as its chat callback.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Callable, List, Optional

logger = logging.getLogger("toolbox.llm.chat")

SYSTEM_PROMPT = "你是一个友善的语音助手，回答要简洁自然，适合朗读。"


class ChatClient:
    def __init__(self, base_url: Optional[str] = None,
                 model: Optional[str] = None,
                 api_key: Optional[str] = None):
        self.base_url = base_url or os.getenv("LLM_BASE_URL", "")
        self.model = model or os.getenv("LLM_MODEL", "qwen3-32b")
        self.api_key = api_key or os.getenv("LLM_API_KEY", "")
        self.history: List[dict] = [{"role": "system", "content": SYSTEM_PROMPT}]

    @property
    def enabled(self) -> bool:
        return bool(self.base_url)

    def _headers(self) -> dict:
        h = {"Content-Type": "application/json"}
        if self.api_key:
            h["Authorization"] = f"Bearer {self.api_key}"
        return h

    def chat_with_qwen(self, text: str,
                       on_token: Optional[Callable[[str], None]] = None) -> str:
        """Streaming chat; tokens go to `on_token`, full reply returned.
        Says nothing (returns "") when no endpoint is configured."""
        if not self.enabled:
            return ""
        import httpx
        self.history.append({"role": "user", "content": text})
        url = self.base_url.rstrip("/") + "/chat/completions"
        payload = {"model": self.model, "messages": self.history,
                   "stream": True, "temperature": 0.7}
        reply = ""
        try:
            with httpx.Client(timeout=60.0) as client:
                with client.stream("POST", url, json=payload,
                                   headers=self._headers()) as r:
                    r.raise_for_status()
                    for line in r.iter_lines():
                        if not line.startswith("data:"):
                            continue
                        data = line[5:].strip()
                        if data == "[DONE]":
                            break
                        try:
                            delta = json.loads(data)["choices"][0]["delta"]
                        except (json.JSONDecodeError, KeyError, IndexError):
                            continue
                        tok = delta.get("content", "")
                        if tok:
                            reply += tok
                            if on_token:
                                on_token(tok)
        except Exception:
            logger.exception("chat stream failed")
        if reply:
            self.history.append({"role": "assistant", "content": reply})
        return reply

    def reset(self) -> None:
        self.history = [{"role": "system", "content": SYSTEM_PROMPT}]
