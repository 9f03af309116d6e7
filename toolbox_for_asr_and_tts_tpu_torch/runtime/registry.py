"""Model registry: name → resolved checkpoint directory.

Copy of `toolbox_for_asr_and_tts_tpu/runtime/registry.py` for the port
(framework-free; imports kept relative).

Port of the reference's 3-level model resolution
(voice-service/app/services/voice_interface.py:593-642): container path
(`/workspace/models/damo/<dir>`) → in-tree dev path → ModelScope download by
ID+revision. The ModelScope leg runs only if the `modelscope` package is
importable (it is not in the CI image); otherwise resolution stops at the
filesystem, mirroring the reference's offline behavior with pre-mounted
volumes.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

logger = logging.getLogger("toolbox.registry")


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str                  # directory name under models/damo
    modelscope_id: str
    revision: Optional[str] = None


# the reference's model set (survey §2.2)
MODELS = {
    "fsmn_vad": ModelSpec(
        "speech_fsmn_vad_zh-cn-16k-common-pytorch",
        "iic/speech_fsmn_vad_zh-cn-16k-common-pytorch"),
    "paraformer_offline": ModelSpec(
        "speech_paraformer-large_asr_nat-zh-cn-16k-common-vocab8404",
        "iic/speech_paraformer-large_asr_nat-zh-cn-16k-common-vocab8404-pytorch"),
    "paraformer_streaming": ModelSpec(
        "speech_paraformer-large_asr_nat-zh-cn-16k-common-vocab8404-online",
        "iic/speech_paraformer-large_asr_nat-zh-cn-16k-common-vocab8404-online"),
    "punc": ModelSpec(
        "punc_ct-transformer_cn-en-common-vocab471067-large",
        "iic/punc_ct-transformer_cn-en-common-vocab471067-large"),
    "diarization": ModelSpec(
        "speech_paraformer-large-vad-punc-spk_asr_nat-zh-cn",
        "iic/speech_paraformer-large-vad-punc-spk_asr_nat-zh-cn",
        revision="v2.0.4"),
    "sv": ModelSpec(
        "speech_campplus_sv_zh-cn_16k-common",
        "iic/speech_campplus_sv_zh-cn_16k-common"),
    "kws": ModelSpec(
        "speech_charctc_kws_phone-xiaohu",
        "iic/speech_charctc_kws_phone-xiaohu"),
    "tts": ModelSpec(
        "speech_sambert-hifigan_tts_zh-cn_16k",
        "damo/speech_sambert-hifigan_tts_zh-cn_16k"),
}

CONTAINER_ROOT = "/workspace/models/damo"


def resolve(key: str, model_root: Optional[str] = None) -> Optional[str]:
    """Returns a local directory for the model, or None if unavailable."""
    spec = MODELS[key]
    candidates = []
    if model_root:
        candidates.append(os.path.join(model_root, spec.name))
    candidates.append(os.path.join(CONTAINER_ROOT, spec.name))
    candidates.append(os.path.join("models", "damo", spec.name))
    for c in candidates:
        if os.path.isdir(c):
            return c
    try:  # ModelScope download (not available in the CI image)
        from modelscope.hub.snapshot_download import snapshot_download
        kwargs = {"revision": spec.revision} if spec.revision else {}
        path = snapshot_download(spec.modelscope_id, **kwargs)
        logger.info("downloaded %s → %s", spec.modelscope_id, path)
        return path
    except Exception:
        logger.warning("model %s unresolved (no local dir, no modelscope)",
                       key)
        return None
