"""Wire-format schemas of the voice service, without pydantic.

Port of the voice half of `toolbox_for_asr_and_tts_tpu/service/schemas.py`
(`ASRRequest`, `ASRResponse`) as validating dataclasses
(`runtime/config.py::Model`): the same field names and defaults, and
`ASRRequest.model_validate` refuses a missing or mistyped `audio_data` as
the pydantic model does, with `ValidationError`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..runtime.config import Model, ValidationError

__all__ = ["ASRRequest", "ASRResponse", "ValidationError"]


@dataclasses.dataclass
class ASRRequest(Model):
    audio_data: str                      # base64 WAV
    use_wake: Optional[bool] = None      # None → default True (reference)
    use_llm: Optional[bool] = None
    save_sample: bool = False
    sample_id: Optional[str] = None
    diagnosis_session_id: Optional[str] = None


@dataclasses.dataclass
class ASRResponse(Model):
    text: str = ""
    success: bool = True
    message: str = ""
    sample_id: Optional[str] = None
