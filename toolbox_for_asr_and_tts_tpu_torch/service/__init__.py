"""Copy of `toolbox_for_asr_and_tts_tpu/service/__init__.py` for the port
(framework-free; imports kept relative)."""
from .http import App, HTTPError, Request, Response, WebSocket

__all__ = ["App", "HTTPError", "Request", "Response", "WebSocket"]
