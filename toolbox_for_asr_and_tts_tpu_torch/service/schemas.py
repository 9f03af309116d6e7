"""Wire-format schemas of the voice and TTS services, without pydantic.

Port of `toolbox_for_asr_and_tts_tpu/service/schemas.py` (`ASRRequest`,
`ASRResponse`, `TTSRequest`, `CancelRequest`, `TTSResponse`,
`TTSResultResponse`) as validating
dataclasses (`runtime/config.py::Model`): the same field names and
defaults, and `model_validate` refuses a missing or mistyped field (such as
`audio_data`, `text` or `job_id`) as the pydantic model does, with
`ValidationError`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..runtime.config import Model, ValidationError

__all__ = ["ASRRequest", "ASRResponse", "CancelRequest", "TTSRequest",
           "TTSResponse", "TTSResultResponse", "ValidationError"]


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


@dataclasses.dataclass
class TTSRequest(Model):
    text: str
    voice: str = "zhitian_emo"


@dataclasses.dataclass
class CancelRequest(Model):
    job_id: str


@dataclasses.dataclass
class TTSResponse(Model):
    job_id: str
    status: str = "pending"
    message: str = ""


@dataclasses.dataclass
class TTSResultResponse(Model):
    """The body of `GET /api/v1/tts/result/{job_id}` (`service/tts_app.py`,
    `tts/jobs.py::get_result`)."""
    job_id: str
    status: str
    audio_base64: Optional[str] = None
    text: Optional[str] = None
    audio_size: int = 0
    error: Optional[str] = None
    # beyond the reference's service (streamed jobs, tts/jobs.py): progress
    # gauges, and with ?partial=1 audio_base64 carries the audio so far
    segments_done: int = 0
    n_segments: Optional[int] = None
