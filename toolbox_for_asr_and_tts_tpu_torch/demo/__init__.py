"""The voice-agent demo loop (VAD → KWS → SV → ASR → LLM → TTS)."""
