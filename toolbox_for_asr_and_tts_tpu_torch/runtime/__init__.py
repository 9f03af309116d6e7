"""Runtime pieces of the port: the device mesh (`mesh.py`), shape
bucketing, the services' configs, stage timing and RTF metrics, the
Prometheus and model registries, the checkpoint converter
(`checkpoints.py`) and the `torch.profiler` helpers (`profiling.py`)."""
from .mesh import serving_mesh, local_device_count, shard_batch
from .bucketing import Bucketer, DEFAULT_AUDIO_BUCKETS_S
from .config import VoiceConfig, TTSConfig, load_voice_config, load_tts_config
from .metrics import StageTimer, RTFMeter, timing_log

__all__ = [
    "serving_mesh",
    "local_device_count",
    "shard_batch",
    "Bucketer",
    "DEFAULT_AUDIO_BUCKETS_S",
    "VoiceConfig",
    "TTSConfig",
    "load_voice_config",
    "load_tts_config",
    "StageTimer",
    "RTFMeter",
    "timing_log",
]
