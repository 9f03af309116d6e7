"""HTTP smoke test of both services.

Port of `toolbox_for_asr_and_tts_tpu/tools/smoke_http.py`, over the
standard library's `urllib` (no httpx). Probes both services end to end:
health, batch ASR with a synthetic tone, and a full TTS job round trip.
Exits 1 if either fails.

    python -m toolbox_for_asr_and_tts_tpu_torch.tools.smoke_http \\
        [--voice http://localhost:7701] [--tts http://localhost:19001]
"""
from __future__ import annotations

import argparse
import base64
import json
import sys
import time
import urllib.request

import numpy as np


def _tone(secs=1.0):
    t = np.arange(int(16000 * secs)) / 16000
    return (0.3 * np.sin(2 * np.pi * 300 * t)).astype(np.float32)


def _request(method: str, url: str, body=None, timeout: float = 30):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"} if data else {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read() or b"null")


def smoke_voice(base: str) -> dict:
    from ..utils.audio import encode_wav_bytes
    out = {"health": _request("GET", f"{base}/health")}
    b64 = base64.b64encode(encode_wav_bytes(_tone(), 16000)).decode()
    out["asr"] = _request("POST", f"{base}/api/v1/voice/asr",
                          {"audio_data": b64, "use_wake": False,
                           "use_llm": False}, timeout=300)
    return out


def smoke_tts(base: str) -> dict:
    out = {"health": _request("GET", f"{base}/health")}
    job_id = _request("POST", f"{base}/api/v1/tts/start",
                      {"text": "你好。合成测试。"})["job_id"]
    for _ in range(600):
        body = _request("GET", f"{base}/api/v1/tts/result/{job_id}")
        if body["status"] in ("completed", "error"):
            break
        time.sleep(0.5)
    out["tts"] = {"status": body["status"],
                  "audio_bytes": len(base64.b64decode(
                      body.get("audio_base64") or b""))}
    _request("DELETE", f"{base}/api/v1/tts/jobs/{job_id}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--voice", default="http://localhost:7701")
    ap.add_argument("--tts", default="http://localhost:19001")
    ap.add_argument("--skip-voice", action="store_true")
    ap.add_argument("--skip-tts", action="store_true")
    args = ap.parse_args(argv)
    report = {}
    ok = True
    if not args.skip_voice:
        try:
            report["voice"] = smoke_voice(args.voice)
            ok = report["voice"]["asr"].get("success") is True
        except Exception as e:
            report["voice"] = {"error": str(e)}
            ok = False
    if not args.skip_tts:
        try:
            report["tts"] = smoke_tts(args.tts)
            ok = ok and report["tts"]["tts"]["status"] == "completed"
        except Exception as e:
            report["tts"] = {"error": str(e)}
            ok = False
    print(json.dumps(report, ensure_ascii=False))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
