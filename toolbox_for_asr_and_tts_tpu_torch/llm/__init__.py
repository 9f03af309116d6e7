"""Copy of `toolbox_for_asr_and_tts_tpu/llm/__init__.py` for the port
(framework-free; imports kept relative)."""
from .chat import ChatClient
from .correction import (LLMCorrector, correct_text_only,
                         load_hotword_options, load_hotwords_list,
                         process_speech_result, process_with_context)

__all__ = ["ChatClient", "LLMCorrector", "correct_text_only",
           "load_hotword_options", "load_hotwords_list",
           "process_speech_result", "process_with_context"]
