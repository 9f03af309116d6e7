"""Port `tools/rehearse.py` and `cli rehearse` (tests/test_rehearse.py,
mirrored on the port) on a synthetic zoo laid out as that test's: strict
per-family conversion coverage, both services booted on the converted
weights and driven through REST, WS and a TTS job, the JSON report and the
exit codes. The coverage reports equal the reference rehearsal's on the
same zoo, and `--reconvert` leaves the reference's caches in place."""
import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_port_helpers import write_zoo, zoo_state_dicts  # noqa: E402
from toolbox_for_asr_and_tts_tpu.tools import rehearse as JR  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch import cli  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.runtime.registry import MODELS  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.tools import rehearse as R  # noqa: E402

FAMILIES = ("paraformer_offline", "paraformer_streaming", "fsmn_vad", "sv",
            "punc", "kws", "tts")
COVERAGE = ("status", "n_rules", "n_converted", "missing", "unmapped")


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    return write_zoo(tmp_path_factory.mktemp("modelzoo"), zoo_state_dicts())


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("VOICE_DISABLE_LLM", "1")


def _broken_copy(zoo, dst):
    """The zoo with one KWS tensor renamed; returns (root, the old name)."""
    shutil.copytree(zoo, dst)
    d = dst / MODELS["kws"].name
    sd = torch.load(d / "model.pt", weights_only=True)
    key = sorted(sd)[0]
    sd["totally_wrong_name"] = sd.pop(key)
    torch.save(sd, d / "model.pt")
    (d / "torch_params.npz").unlink(missing_ok=True)
    return dst, key


def test_rehearse_green_on_synthetic_zoo(zoo):
    report = R.rehearse(str(zoo), serve=True, device="cpu")
    fams = report["families"]
    for key in FAMILIES:
        assert fams[key]["status"] in ("converted", "cached"), fams[key]
        assert not fams[key].get("missing"), (key, fams[key]["missing"][:5])
        assert not fams[key].get("unmapped"), (key, fams[key]["unmapped"][:5])
    svc = report["service"]
    assert svc["rest_asr"]["success"] is True and svc["rest_asr"]["text"]
    assert svc["ws_asr"]["ok"] is True
    assert "result" in svc["ws_asr"]["frames"]
    assert svc["tts"]["status"] == "completed"
    assert svc["tts"]["audio_size"] > 0 and not svc["tts"]["random_weights"]
    assert all(svc[k]["seconds"] >= 0 for k in ("rest_asr", "ws_asr", "tts"))
    assert report["ok"], report["strict_failures"]


def test_rehearse_strict_fails_on_renamed_key(zoo, tmp_path):
    """A renamed tensor fails loudly, with the bad family and the missing
    and unmapped names in the report."""
    broken, key = _broken_copy(zoo, tmp_path / "broken_zoo")
    report = R.rehearse(str(broken), serve=False, reconvert=True,
                        device="cpu")
    assert not report["ok"]
    assert "kws" in report["strict_failures"]
    entry = report["families"]["kws"]
    assert entry["status"] == "failed"
    assert key in entry.get("missing", [])
    assert "totally_wrong_name" in entry.get("unmapped", [])


def test_rehearse_cli_exit_codes(zoo, tmp_path, capsys):
    R.main([str(zoo), "--no-serve", "--device", "cpu", "--report",
            str(tmp_path / "rehearsal_report.json")])
    out = capsys.readouterr().out
    report = json.loads(out.strip().splitlines()[-1])
    assert json.loads((tmp_path / "rehearsal_report.json").read_text(
        encoding="utf-8")) == report
    assert report["ok"] is True
    # through the CLI: a strict failure exits 1, --lenient exits 0
    broken, _ = _broken_copy(zoo, tmp_path / "broken_zoo")
    argv = ["rehearse", str(broken), "--no-serve", "--device", "cpu",
            "--report", str(tmp_path / "broken_report.json")]
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 1
    cli.main(argv + ["--lenient"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "strict_failures"] == ["kws"]


def test_coverage_equals_the_reference_and_keeps_its_caches(zoo, tmp_path):
    """On one copy of the zoo: the reference's rehearsal converts first
    (its `.jax` caches), then the port's with --reconvert. The per-family
    coverage is the same, the reference's caches are still there, and the
    port wrote its own."""
    root = tmp_path / "shared"
    shutil.copytree(zoo, root, ignore=shutil.ignore_patterns("*.npz",
                                                             "*.cfg.json"))
    want = JR.convert_families(str(root), reconvert=True)
    ref_caches = sorted(p.relative_to(root) for p in root.rglob("*")
                        if ".jax" in p.name or p.name == "jax_params.npz")
    assert len(ref_caches) >= 6
    got = R.convert_families(str(root), reconvert=True, device="cpu")
    for key in FAMILIES:
        assert got[key]["status"] == "converted", got[key]
        assert {k: got[key].get(k) for k in COVERAGE} == \
            {k: want[key].get(k) for k in COVERAGE}, key
    assert sorted(p.relative_to(root) for p in root.rglob("*")
                  if ".jax" in p.name or p.name == "jax_params.npz") \
        == ref_caches
    assert len(list(root.rglob("torch_params.npz"))) == 6
    assert len(list(root.rglob("*.torch.npz"))) == 2
    # a second port rehearsal without --reconvert reads its caches
    again = R.convert_families(str(root), device="cpu")
    assert {v["status"] for v in again.values()} == {"cached"}


def test_clear_caches_removes_only_the_ports(tmp_path):
    names = ("torch_params.npz", "ckpt.pth.torch.npz",
             "ckpt.pth.torch.cfg.json", "jax_params.npz", "ckpt.pth.jax.npz",
             "ckpt.pth.jax.cfg.json", "model.pt")
    for n in names:
        (tmp_path / n).write_bytes(np.zeros(1).tobytes())
    R._clear_caches(str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        ("jax_params.npz", "ckpt.pth.jax.npz", "ckpt.pth.jax.cfg.json",
         "model.pt"))
