"""Model cache report: which model directories resolve under a root, which
hold a torch checkpoint, the port's converted cache (`torch_params.npz`)
and a CMVN file, and the environment knobs that affect resolution.

    python -m toolbox_for_asr_and_tts_tpu_torch.tools.check_cache [ROOT]

Copy of `toolbox_for_asr_and_tts_tpu/tools/check_cache.py` reporting the
port's cache names. ROOT defaults to VOICE_MODEL_DIR, else
/workspace/models/damo.
"""
from __future__ import annotations

import json
import os

from ..runtime.checkpoints import CACHE_NAME, find_checkpoint
from ..runtime.registry import CONTAINER_ROOT, MODELS

KNOWN_MODEL_DIRS = [MODELS[k].name for k in (
    "paraformer_offline", "paraformer_streaming", "fsmn_vad", "punc", "sv",
    "kws", "tts")]


def check(model_root: str = None) -> dict:
    model_root = model_root or os.getenv("VOICE_MODEL_DIR", CONTAINER_ROOT)
    report = {"model_root": model_root,
              "root_exists": os.path.isdir(model_root),
              "env": {k: os.getenv(k) for k in
                      ("VOICE_MODEL_DIR", "TTS_MODEL_DIR", "MODELSCOPE_CACHE",
                       "HOTWORDS_FILE")},
              "models": {}}
    for name in KNOWN_MODEL_DIRS:
        d = os.path.join(model_root, name)
        entry = {"present": os.path.isdir(d)}
        if entry["present"]:
            entry["has_torch_ckpt"] = find_checkpoint(d) is not None
            entry["has_converted_npz"] = os.path.exists(
                os.path.join(d, CACHE_NAME))
            entry["has_cmvn"] = os.path.exists(os.path.join(d, "am.mvn"))
        report["models"][name] = entry
    return report


def main() -> None:
    import sys
    root = sys.argv[1] if len(sys.argv) > 1 else None
    print(json.dumps(check(root), indent=2, ensure_ascii=False))


if __name__ == "__main__":
    main()
