"""The port's yardsticks against the reference's, on the CPU:
`tools/wer.py` (each public function on `tests/test_wer.py`'s cases and on
seeded random strings; the CLI on golden and hypothesis files),
`tools/mel_distance.py` (within 1e-4 of the reference's on seeded audio,
through the port's own fbank) and `runtime/profiling.py` (the counterpart
of `tests/test_runtime.py::test_profiling_helpers`)."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from toolbox_for_asr_and_tts_tpu.tools import mel_distance as jmd  # noqa: E402
from toolbox_for_asr_and_tts_tpu.tools import wer as jwer  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.runtime import profiling  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.tools import mel_distance as md  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.tools import wer  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.utils.audio import encode_wav_bytes  # noqa: E402

SR = 16000
# tests/test_wer.py's cases
EDIT_CASES = [("abc", "axc"), ("abc", "ab"), ("abc", "abcd"), ("", "ab")]
TEXT_CASES = ["你好，world。", "血压120高", "你好世界", "你坏世界", "你好。",
              "你好", "", "四字成语", "四字成句", "Hello, 世界 ABC123!"]
PAIRS = [("你好", "你好"), ("四字成语", "四字成句"), ("你好世界", "你坏世界"),
         ("你好。", "你好"), ("", "")]
ALPHABET = list("你好世界血压高低四字成语句ab1 ，。!?")


def _random_strings(seed, n=40, max_len=12):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(ALPHABET, int(rng.integers(0, max_len))))
            for _ in range(n)]


def test_wer_functions_match_reference():
    for ref, hyp in EDIT_CASES:
        assert wer.edit_distance(list(ref), list(hyp)) == \
            jwer.edit_distance(list(ref), list(hyp))
    for text in TEXT_CASES:
        assert wer.normalize_zh(text) == jwer.normalize_zh(text)
    for ref, hyp in PAIRS:
        assert wer.cer(ref, hyp) == jwer.cer(ref, hyp)
    assert wer.corpus_cer(PAIRS) == jwer.corpus_cer(PAIRS)
    # tests/test_wer.py's expectations, on the port
    assert wer.cer("你好世界", "你坏世界") == 0.25
    assert abs(wer.corpus_cer(PAIRS[:2])["cer"] - 1 / 6) < 1e-9


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wer_on_random_strings_matches_reference(seed):
    refs, hyps = _random_strings(seed), _random_strings(seed + 100)
    for r, h in zip(refs, hyps):
        assert wer.normalize_zh(r) == jwer.normalize_zh(r)
        assert wer.edit_distance(r, h) == jwer.edit_distance(r, h)
        assert wer.cer(r, h) == jwer.cer(r, h)
    pairs = list(zip(refs, hyps))
    assert wer.corpus_cer(pairs) == jwer.corpus_cer(pairs)


def test_wer_cli_matches_reference(tmp_path, capsys, monkeypatch):
    """`--golden` with `--hyp`: the printed corpus stats equal the
    reference CLI's; a wav with no hypothesis scores as deleted."""
    golden, hyp = tmp_path / "golden.jsonl", tmp_path / "hyp.jsonl"
    items = [{"wav": f"{i}.wav", "text": r} for i, (r, _) in enumerate(PAIRS)]
    golden.write_text("\n".join(json.dumps(x, ensure_ascii=False)
                                for x in items) + "\n", encoding="utf-8")
    hyp.write_text("\n".join(json.dumps({"wav": f"{i}.wav", "text": h},
                                        ensure_ascii=False)
                             for i, (_, h) in enumerate(PAIRS[1:], 1))
                   + "\n", encoding="utf-8")
    args = ["--golden", str(golden), "--hyp", str(hyp)]
    stats = wer.main(args)
    got = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["wer"] + args)
    jwer.main()
    assert json.loads(got) == json.loads(capsys.readouterr().out) == stats


def _audio(seed, secs=1.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * secs)) / SR
    f = rng.uniform(150, 600)
    return (0.3 * np.sin(2 * np.pi * f * t)
            + 0.05 * rng.standard_normal(len(t))).astype(np.float32)


def test_mel_distance_matches_reference():
    """Seeded audio pairs of equal and unequal length: every stat within
    1e-4 of the reference's (its fbank and the port's agree to float32
    rounding); the reference test's ordering (same < different) holds."""
    pairs = [(_audio(0), _audio(0)), (_audio(0), _audio(1)),
             (_audio(2, 1.3), _audio(3, 1.1))]
    for a, b in pairs:
        got = md.mel_distance(a, b, device="cpu")
        want = jmd.mel_distance(a, b)
        assert got["frames"] == want["frames"]
        for k in ("len_ratio", "rmse_db", "corr"):
            assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    np.testing.assert_allclose(md.log_mel(pairs[1][1], device="cpu"),
                               jmd.log_mel(pairs[1][1]), rtol=0, atol=1e-4)
    same = md.mel_distance(pairs[0][0], pairs[0][1], device="cpu")
    diff = md.mel_distance(*pairs[1], device="cpu")
    assert same["rmse_db"] < 1e-4 and same["corr"] > 0.999
    assert diff["rmse_db"] > same["rmse_db"] + 1.0


def test_mel_distance_cli(tmp_path, capsys):
    paths = []
    for i, x in enumerate((_audio(4), _audio(5))):
        p = tmp_path / f"{i}.wav"
        p.write_bytes(encode_wav_bytes(x, SR))
        paths.append(str(p))
    out = md.main(paths + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == out
    assert out["frames"] > 0 and out["rmse_db"] > 1.0


def test_profiling_helpers(tmp_path):
    """`trace_to` writes one Chrome trace into the directory that names the
    `annotate` region; `device_memory_stats` returns a dict with the
    reference's keys."""
    with profiling.trace_to(str(tmp_path / "tb"), device="cpu") as path:
        with profiling.annotate("work"):
            torch.ones(128).sum().item()
    assert os.path.dirname(path) == str(tmp_path / "tb")
    assert os.listdir(tmp_path / "tb") == [os.path.basename(path)]
    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "work" in names
    stats = profiling.device_memory_stats(device="cpu")
    assert isinstance(stats, dict) and len(stats) >= 1
    for gauges in stats.values():
        assert sorted(gauges) == sorted(profiling.MEMORY_KEYS)
