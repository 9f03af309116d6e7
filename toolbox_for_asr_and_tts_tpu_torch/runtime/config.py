"""Env-var driven configuration of the voice and TTS services, without
pydantic.

Port of `toolbox_for_asr_and_tts_tpu/runtime/config.py` (`ServerConfig`,
`SSLConfig`, `SecurityConfig`, `VoiceConfig`, `TTSConfig`,
`load_voice_config`, `load_tts_config`). The
reference builds these on pydantic v2 models; the port's machines have no
pydantic, so they are dataclasses that validate their fields as pydantic's
lax mode does: the same field names and defaults, the same env reading, and
the same accepted inputs and refusals (a str field takes str or bytes only;
an int takes ints, integral floats, bools and integer strings; a float
takes numbers and numeric strings; a bool takes bools, 0/1 and the strings
0/1, off/on, f/t, false/true, n/y, no/yes in any case; a nested config
takes a dict or an instance; unknown keys are ignored by
`model_validate`). A refusal raises `ValidationError`, whose message
follows pydantic's layout.
"""
from __future__ import annotations

import dataclasses
import os
import typing
from typing import Any, Dict, List, Optional, Tuple

_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}


class ValidationError(ValueError):
    """The refusals of one validation: [(location, message, type, input)]."""

    def __init__(self, title: str, errors: List[Tuple[str, str, str, Any]]):
        self.title = title
        self.error_list = errors
        n = len(errors)
        lines = [f"{n} validation error{'s' if n != 1 else ''} for {title}"]
        for loc, msg, kind, value in errors:
            if loc:
                lines.append(loc)
            lines.append(f"  {msg} [type={kind}, input_value={value!r}, "
                         f"input_type={type(value).__name__}]")
        super().__init__("\n".join(lines))

    def errors(self) -> List[Dict[str, Any]]:
        return [{"loc": tuple(loc.split(".")) if loc else (), "msg": msg,
                 "type": kind, "input": value}
                for loc, msg, kind, value in self.error_list]


class _Refused(Exception):
    def __init__(self, msg: str, kind: str):
        super().__init__(msg)
        self.msg, self.kind = msg, kind


def _coerce(value: Any, tp: Any, loc: str, errors: list) -> Any:
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if value is None:
            return None
        tp, origin = args[0], typing.get_origin(args[0])
    if dataclasses.is_dataclass(tp):
        if isinstance(value, tp):
            return value
        if isinstance(value, dict):
            sub: list = []
            out = tp._from_dict(value, sub, prefix=f"{loc}.")
            errors.extend(sub)
            return out
        errors.append((loc, f"Input should be a valid dictionary or instance "
                            f"of {tp.__name__}", "model_type", value))
        return None
    try:
        if origin in (list, List):
            (item,) = typing.get_args(tp) or (Any,)
            if not isinstance(value, (list, tuple, set, frozenset)):
                raise _Refused("Input should be a valid list", "list_type")
            return [_coerce(v, item, f"{loc}.{i}", errors)
                    for i, v in enumerate(value)]
        if tp is str:
            if isinstance(value, str):
                return value
            if isinstance(value, bytes):
                return value.decode("utf-8")
            raise _Refused("Input should be a valid string", "string_type")
        if tp is bool:
            if isinstance(value, bool):
                return value
            if isinstance(value, (int, float)) and value in (0, 1):
                return bool(value)
            if isinstance(value, str):
                if value.lower() in _TRUE:
                    return True
                if value.lower() in _FALSE:
                    return False
                raise _Refused("Input should be a valid boolean, unable to "
                               "interpret input", "bool_parsing")
            if isinstance(value, int):
                raise _Refused("Input should be a valid boolean, unable to "
                               "interpret input", "bool_parsing")
            raise _Refused("Input should be a valid boolean", "bool_type")
        if tp is int:
            if isinstance(value, int):
                return int(value)
            if isinstance(value, float):
                if value.is_integer():
                    return int(value)
                raise _Refused("Input should be a valid integer, got a "
                               "number with a fractional part",
                               "int_from_float")
            if isinstance(value, str):
                try:
                    return int(value.strip())
                except ValueError:
                    raise _Refused("Input should be a valid integer, unable "
                                   "to parse string as an integer",
                                   "int_parsing") from None
            raise _Refused("Input should be a valid integer", "int_type")
        if tp is float:
            if isinstance(value, (int, float)):
                return float(value)
            if isinstance(value, str):
                try:
                    return float(value.strip())
                except ValueError:
                    raise _Refused("Input should be a valid number, unable "
                                   "to parse string as a number",
                                   "float_parsing") from None
            raise _Refused("Input should be a valid number", "float_type")
    except _Refused as r:
        errors.append((loc, r.msg, r.kind, value))
        return None
    return value


class Model:
    """Validation for a dataclass, as pydantic's lax mode: fields are
    coerced at construction, and `model_validate` takes a dict (unknown
    keys ignored) or an instance."""

    @classmethod
    def _hints(cls) -> Dict[str, Any]:
        return typing.get_type_hints(cls)

    def __post_init__(self) -> None:
        errors: list = []
        hints = self._hints()
        for f in dataclasses.fields(self):
            object.__setattr__(self, f.name, _coerce(
                getattr(self, f.name), hints[f.name], f.name, errors))
        if errors:
            raise ValidationError(type(self).__name__, errors)

    @classmethod
    def _from_dict(cls, data: dict, errors: list, prefix: str = ""):
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name in data:
                kw[f.name] = data[f.name]
            elif (f.default is dataclasses.MISSING
                  and f.default_factory is dataclasses.MISSING):
                errors.append((prefix + f.name, "Field required", "missing",
                               data))
        if errors:
            return None
        try:
            return cls(**kw)
        except ValidationError as e:
            errors.extend((prefix + loc, msg, kind, value)
                          for loc, msg, kind, value in e.error_list)
            return None

    @classmethod
    def model_validate(cls, obj: Any):
        if isinstance(obj, cls):
            return obj
        if not isinstance(obj, dict):
            raise ValidationError(cls.__name__, [(
                "", f"Input should be a valid dictionary or instance of "
                    f"{cls.__name__}", "model_type", obj)])
        errors: list = []
        out = cls._from_dict(obj, errors)
        if errors:
            raise ValidationError(cls.__name__, errors)
        return out

    def model_dump(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _env_bool(name: str, default: bool) -> bool:
    v = os.getenv(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def _env_int(name: str, default: int) -> int:
    v = os.getenv(name)
    return int(v) if v not in (None, "") else default


def _env_list(name: str, default: List[str]) -> List[str]:
    v = os.getenv(name)
    if v is None:
        return list(default)
    return [s.strip() for s in v.split(",") if s.strip()]


@dataclasses.dataclass
class ServerConfig(Model):
    host: str = "0.0.0.0"
    port: int = 8001


@dataclasses.dataclass
class SSLConfig(Model):
    enabled: bool = False
    certfile: Optional[str] = None
    keyfile: Optional[str] = None


@dataclasses.dataclass
class SecurityConfig(Model):
    allowed_hosts: List[str] = dataclasses.field(default_factory=lambda: ["*"])
    cors_origins: List[str] = dataclasses.field(default_factory=lambda: ["*"])


@dataclasses.dataclass
class VoiceConfig(Model):
    """Voice-service configuration (reference voice-service/app/config.py)."""

    server: ServerConfig = dataclasses.field(default_factory=ServerConfig)
    ssl: SSLConfig = dataclasses.field(default_factory=SSLConfig)
    security: SecurityConfig = dataclasses.field(default_factory=SecurityConfig)

    funasr_disable_lm: bool = False
    disable_llm: bool = True  # no LLM endpoint by default; enable via env
    always_save_sample: bool = False
    require_wake: bool = False

    # engine knobs (the reference hard-codes these as module globals)
    sample_rate: int = 16000
    chunk_ms: int = 400
    energy_mean_threshold: float = 0.03
    energy_peak_threshold: float = 0.17
    silence_finalize_s: float = 2.0
    kws_window_s: float = 1.6
    kws_keyword: str = "小护"
    sv_threshold: float = 0.40
    min_enroll_seconds: float = 5.0
    pre_speech_buffer_s: float = 0.4
    max_silent_chunks_kept: int = 2

    model_dir: str = "/workspace/models/damo"
    generated_dir: str = "generated"


def load_voice_config() -> VoiceConfig:
    return VoiceConfig(
        server=ServerConfig(
            host=os.getenv("VOICE_HOST", "0.0.0.0"),
            port=_env_int("VOICE_PORT", 8001),
        ),
        ssl=SSLConfig(
            enabled=_env_bool("SSL_ENABLED", False),
            certfile=os.getenv("SSL_CERTFILE"),
            keyfile=os.getenv("SSL_KEYFILE"),
        ),
        security=SecurityConfig(
            allowed_hosts=_env_list("ALLOWED_HOSTS", ["*"]),
            cors_origins=_env_list("CORS_ORIGINS", ["*"]),
        ),
        funasr_disable_lm=_env_bool("FUNASR_DISABLE_LM", False),
        disable_llm=_env_bool("VOICE_DISABLE_LLM", True),
        always_save_sample=_env_bool("VOICE_ALWAYS_SAVE_SAMPLE", False),
        require_wake=_env_bool("VOICE_REQUIRE_WAKE", False),
        model_dir=os.getenv("VOICE_MODEL_DIR", "/workspace/models/damo"),
        generated_dir=os.getenv("GENERATED_DIR", "generated"),
    )


@dataclasses.dataclass
class TTSConfig(Model):
    """TTS-service configuration (reference tts_service.py:51-76 env knobs).

    The reference's `beam_size`, `parallel_segments`,
    `max_parallel_segments`, `use_batch` and `default_voice` (TTS_BEAM_SIZE,
    TTS_PARALLEL_SEGMENTS, TTS_MAX_PARALLEL_SEGMENTS, TTS_USE_BATCH,
    TTS_DEFAULT_VOICE) are left out: no module of either package reads
    them, so setting them would change nothing."""

    server: ServerConfig = dataclasses.field(
        default_factory=lambda: ServerConfig(port=7001))
    ssl: SSLConfig = dataclasses.field(default_factory=SSLConfig)

    seg_target: int = 18
    seg_first: int = 14
    seg_hard_max: int = 22
    crossfade_ms: int = 60
    pause_soft_ms: int = 120
    pause_hard_ms: int = 200
    sampling_rate: int = 16000
    batch_size: int = 8
    max_concurrent_jobs: int = 2

    model_dir: str = "/workspace/models/damo"


def load_tts_config() -> TTSConfig:
    return TTSConfig(
        server=ServerConfig(
            host=os.getenv("TTS_HOST", "0.0.0.0"),
            port=_env_int("TTS_PORT", 7001),
        ),
        ssl=SSLConfig(
            enabled=_env_bool("SSL_ENABLED", False),
            certfile=os.getenv("SSL_CERTFILE"),
            keyfile=os.getenv("SSL_KEYFILE"),
        ),
        seg_target=_env_int("TTS_SEG_TARGET", 18),
        seg_first=_env_int("TTS_SEG_FIRST", 14),
        seg_hard_max=_env_int("TTS_SEG_HARD_MAX", 22),
        crossfade_ms=_env_int("TTS_CROSSFADE_MS", 60),
        pause_soft_ms=_env_int("TTS_PAUSE_SOFT_MS", 120),
        pause_hard_ms=_env_int("TTS_PAUSE_HARD_MS", 200),
        sampling_rate=_env_int("TTS_SAMPLING_RATE", 16000),
        batch_size=_env_int("TTS_BATCH_SIZE", 8),
        max_concurrent_jobs=_env_int("TTS_MAX_JOBS", 2),
        model_dir=os.getenv("TTS_MODEL_DIR", "/workspace/models/damo"),
    )
