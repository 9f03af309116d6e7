#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py             # from the repository root
    python3 chip_smoke.py --profile   # also: torch.profiler breakdown of one
                                      # transcribe by CUDA kernel, the
                                      # card's busy time per streaming step,
                                      # over an S = 16 service run and over
                                      # one TTS synthesize, and the stages
                                      # of a Paraformer-large load
    python3 chip_smoke.py --sweep     # also: K1's device time per tile

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit (nvidia-smi); build the CUDA kernels
   from `toolbox_for_asr_and_tts_tpu_torch/csrc/` (nvcc, sm_90a) and the
   native libraries from `toolbox_for_asr_and_tts_tpu_torch/native/` (g++);
2. each kernel against its plain PyTorch version at the main path's shapes
   (TF32 off): K1 in f32 (max|err| 0) and bf16 at the encoder and decoder
   shapes, in the encoder also on the strided V view of a qkv buffer that
   the path passes, with the tile the wrapper chose; K2 in f32; both also at
   the streaming path's shapes (K1: the chunked encoder's V view of
   [S, 9, 1536] at S 64 and 1, FSMN-VAD's [64, 19 + 40, 128] with K 20 and
   pad (19, 0); K2: the fused step's ring [64, 4320] → 25 frames and the
   first VAD tick [64, 6400] → 38 frames); the device
   time of kernel, plain version and one-call library yardstick (CUDA
   events around calls queued behind a spin kernel, so no host gap is
   timed; median), beside the same method's per-launch floor (a 1-cycle
   spin kernel), the kernel's per-call time with its host overhead (CUDA
   events over back-to-back calls), and the least time the card could take
   (bytes or flops over its peak rate). TF32 stays off for every phase;
3. the full-width main path: `Recognizer.random(ParaformerConfig(), seed=0)`
   (Paraformer-large: 50 + 16 layers, d 512, vocab 8404) transcribes a
   batch of 8 x up to 10 s of 16 kHz audio, with and without hotwords; the
   kernels' launch counters are zeroed just before each transcribe and read
   just after; RTF of the batch; then the card's forward pass is held
   against the same port on the CPU for 2 of the rows;
4. the streaming path at full width: `BatchedChunkedASR(ParaformerConfig(),
   OnlineConfig(), capacity=64, partials=True)` on S = 1, 16 and 64 live
   sessions of 3.2-8 s each, fed in 0.4 s chunks and then finalized; per
   run the launch counters are zeroed just before and read just after (K1
   50 and K2 1 per chunked step), and the per-step wall time (host clock,
   ending in the fetch) is printed with its real-time share; then
   `BatchedVadTicker(FsmnVadConfig(), capacity=64)` on 64 sessions (K1 4
   and K2 1 per tick); with `--profile` the card's busy time per step.
   Two sessions of the S = 16 run are held against a per-session
   `OnlineRecognizer(partial_mode="incremental")` on the card (ids equal)
   and, through the ticker step's halves (`fused_encode`, `fused_decode`)
   and the streaming VAD, against the same on the CPU (fired counts equal,
   embeddings within 1e-3, ids equal where the top-2 logit gap exceeds
   1e-3, VAD decisions equal, posteriors within 1e-4);
5. the voice service at full width (phase 6): the engines wired as
   `service/engines.py::build_engines` wires them (FinalizeHub over the
   Diarizer with Paraformer-large, CAM++ and the large CT-Transformer;
   KwsHub; VadHub and ChunkedHub with 64 rows; random weights from fixed
   seeds), served by the port's `create_app` on 127.0.0.1 and driven by a
   minimal RFC 6455 client (`RawWS`): S = 1 and 16 concurrent sessions of
   real-time 0.4 s PCM chunks (partial and finalize latency, median and
   p95), one session through all four modes (wake → enrollment →
   start_asr → an utterance with SV), and the REST endpoint against a
   direct `Diarizer.diarize`. Around each of these runs the launch
   counters are zeroed just before and read just after, and each kernel's
   launches must equal what the run's device programs launch, as the
   models and tickers count them (chunked steps, transcribes, punctuate
   forwards, embeds, KWS forwards, VAD steps); then the launches per
   punctuate forward, KWS batch and embed around direct calls, and
   CT-Transformer, CAM++ (random BatchNorm statistics) and KWS on the card
   against the CPU; K1 and K2 at the service shapes join phase 2. Each
   audio frame the client sends is followed by a `{"type": "chunk_end"}`
   text frame, answered MISSING_AUDIO_DATA, so that replies can be
   attributed to chunks: extra traffic that real clients do not send;
6. the TTS service at full width (phase 7): `Synthesizer.random(seed=0,
   tiny=False)` on the card (Sambert d 256, 4 + 4 layers, 6 PNCA layers;
   HiFi-GAN 512 channels, upsample (5, 5, 4, 2)), pinned to the serving
   defaults (NAR decoder, two-phase, one call per batch of 8): a fixed
   14-segment paragraph through `synthesize` (one warm-up, then the median
   of 3: wall, audio seconds, RTF, the probes and synth groups run, no K1
   or K2 launch), `synthesize_stream` (time to the first chunk; its
   concatenation against the one-shot waveform within 1 LSB, equal
   lengths), one segment in PNCA mode (AR steps, and the cost of one step
   from `forward_ar` at two mel lengths), card against CPU on 2 segments
   (probes, durations and mel lengths equal, mel within 1e-4 of its
   largest magnitude, PCM within 2 LSB), and the port's TTS app on
   127.0.0.1 (a REST job polled to `completed`, the same text over `WS
   /api/v1/tts/ws`, whose pcm16 must equal the job's WAV samples);
   `--profile` adds the card's busy time over one `synthesize` and the
   PNCA step's launches. No TPU kernel lies on this path;
7. mounted checkpoints at full width (phase 8): the trees of phases 3, 6
   and 7 written under a temporary root as one directory per family in
   FunASR / KAN-TTS naming (`invert_to_state_dict`, `torch.save`, with
   config.json, token lists and am.mvn; Sambert's postnet as BatchNorm,
   HiFi-GAN as weight-norm pairs; the online Paraformer a symlink to the
   offline one), then each family's `from_model_dir` on the card cold
   (converting) and warm (from the port's cache), every tree bit-equal to
   the one in memory; the loaded Paraformer-large transcribes phase 3's
   batch with the token ids of an in-memory recognizer with the same
   am.mvn (K1 66 and K2 1 per transcribe, 82 / 1 with hotwords, counters
   zeroed just before and read just after); `build_engines(model_dir=
   root)` behind `create_app` answers a REST request with the text and
   speakers of an in-memory `Diarizer.diarize`; the loaded CAM++,
   CT-Transformer and KWS give identical embeddings, punctuation ids and
   scores; the loaded KAN-TTS package in PNCA mode gives phase 7's first
   segment sample for sample as an in-memory synthesizer holding the
   weights the package defines; the TTS app from the mount completes a
   job; cold and warm load times, bytes written and start-up times;
   `--profile` adds the stages of one Paraformer-large load;
8. the deployed entry points at full width (phase 9), over phase 8's
   mount: (a) the port's native FunASR WebSocket server in-process
   (`native/bridge.py::start_offline_asr_server` over the mount's engines)
   answers 8 s of phase 6's REST audio in 60 ms s16le frames in modes
   offline (sent at once), online and 2pass (real time); launches held to
   the programs each request ran (counters zeroed just before it and read
   just after); the offline and 2pass-offline texts equal a direct
   `Diarizer.diarize` + ITN on the same samples, and come from the same
   recognition as the REST answer (which takes the hard corrections
   instead of ITN); no ChunkedHub row or streaming session stays in use
   after the connections close; the time from `is_speaking: false` to the
   final frame; (b) `launch_voice()` in a child process, started as the
   deploy image starts it (VOICE_MODEL_DIR = the mount, free VOICE_PORT
   and FUNASR_WS_PORT): one REST and one FunASR offline request answered
   with (a)'s texts, start-up to the first answer and the child's own
   logged `build_engines` time, then SIGTERM → exit 0 within 15 s; (c) the
   CLI in child processes: `transcribe --itn` prints (a)'s text, `tts -o`
   from the mounted package writes a WAV at least as long as phase 8's
   PNCA segment; (d) the native epoll load generator
   (`native/wsload_client.cpp`) against the mount's voice app: 16 streams,
   2 cycles of real-time 0.4 s chunks with no extra frames, every stream
   ok, result latency median and p95, launches accounted. The parts run
   one at a time ((a), (d), then each child alone), so no time is taken
   beside another part's load;
9. the `streaming`, `service`, `tts`, `checkpoints`, `entry_points` and
   `kernels` JSON lines, then the result line {"ok": true, "device":
   {"platform": "gpu", "kind": ..., "count": ...}}.

Needs one card, no network, and only the files of this repository.
"""
from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SR = 16000
ROW_SECONDS = (10.0, 7.3, 3.1, 9.2, 5.5, 8.8, 6.4, 4.7)
CPU_ROWS = (0, 1)            # rows held against the CPU run (same bucket)
K1_SITES = {"encoder": 167, "decoder": 96}   # T at 10 s: LFR frames, k_max


class PhaseError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# ------------------------------------------------------------- the card
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card_peaks(name: str):
    """(memory bytes/s, float32 flop/s outside the tensor cores) from
    NVIDIA's data sheets; unknown cards count as the H100 SXM."""
    n = name.upper()
    if "H200" in n:
        return 4.8e12, 67e12
    if "H100" in n and "PCIE" in n:
        return 2.0e12, 51e12
    if "H100" in n and "NVL" in n:
        return 3.9e12, 60e12
    return 3.35e12, 67e12


def bound(nbytes: float, flops: float, peaks):
    t_bytes, t_ops = nbytes / peaks[0] * 1e3, flops / peaks[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def call_ms(torch, fn, reps: int = 50, rounds: int = 7) -> float:
    """Per-call time of back-to-back calls, host overhead included: median
    over `rounds` of CUDA-event time over `reps` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _device_events(prof):
    return [e for e in prof.key_averages()
            if "CUDA" in str(getattr(e, "device_type", ""))]


_SPIN = {}


def _spin_cycles_per_ms(torch) -> float:
    """Clock cycles per ms of torch.cuda._sleep's spin kernel (CUDA events)."""
    if "per_ms" not in _SPIN:
        cycles = 20_000_000
        torch.cuda._sleep(cycles)              # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        _SPIN["per_ms"] = cycles / start.elapsed_time(end)
    return _SPIN["per_ms"]


def device_ms(torch, fn, reps: int = 10, rounds: int = 7) -> float:
    """Device time per call, host launch gaps left out: a spin kernel
    (torch.cuda._sleep) holds the stream while the host queues `reps` calls
    behind the start event, so the CUDA events time only the card's work.
    A round in which the card reached the start event before the host had
    queued every call is run again with a longer spin. Median over
    `rounds`, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = 2 * host_ms + 1.0
    times = []
    while len(times) < rounds:
        require(spin_ms < 2000, "the host could not queue the calls ahead "
                                "of the card")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * _spin_cycles_per_ms(torch)))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued_ahead = not start.query()
        end.synchronize()
        if queued_ahead:
            times.append(start.elapsed_time(end) / reps)
        else:
            spin_ms *= 2
    return statistics.median(times)


def set_tf32(torch, on: bool) -> str:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    return (f"tf32: torch.backends.cuda.matmul.allow_tf32="
            f"{torch.backends.cuda.matmul.allow_tf32} "
            f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")


# -------------------------------------------------------- phase 2: kernels
K1_D, K1_K, K1_PAD = 512, 11, (5, 5)


def k1_case(torch, site: str, dtype, seed: int):
    """K1's inputs at a main-path site, x as the path passes it: in the
    encoder the V third of a [8, T, 3D] qkv buffer (a strided view), in the
    decoder a contiguous [8, T, D]; w [D, 1, K] f32; a length mask."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    b, t, d = 8, K1_SITES[site], K1_D
    if site == "encoder":
        x = torch.randn((b, t, 3 * d), generator=g,
                        device=dev).to(dtype)[..., 2 * d:]
    else:
        x = torch.randn((b, t, d), generator=g, device=dev).to(dtype)
    w = torch.randn((d, 1, K1_K), generator=g, device=dev) * 0.02
    lens = torch.tensor([t, t * 3 // 4, t // 3, t, t // 2, t - 7,
                         t * 2 // 3, t // 4], device=dev)
    mask = (torch.arange(t, device=dev)[None] < lens[:, None]).float()
    return x, w, mask


def k1_err(torch, got, want) -> float:
    torch.cuda.synchronize()
    return (got.float() - want.float()).abs().max().item()


def k1_measure(torch, peaks, floor_ms: float, site: str, xv, w, pad, mask,
               tol: float, library, kept=None):
    """K1 against its plain version on x as the path passes it (`xv`, a
    view or not) and contiguous; its device time on both, the plain
    version's and the library yardstick's (`library(x, w)`), its bound.
    kept: the output rows the path keeps (the last ones), where it drops
    some; the bound is then that of the function the path needs (x read
    once, the kept rows written), beside the whole call's."""
    from toolbox_for_asr_and_tts_tpu_torch.ops.kernels import fsmn_conv as k1
    x = xv.contiguous()
    b, t, d = x.shape
    k = w.shape[-1]
    tile = k1.tile_for(xv, k)
    errs = [k1_err(torch, k1.fsmn_depthwise(a, w, *pad, mask),
                   k1.fsmn_depthwise_plain(a, w, *pad, mask))
            for a in {id(x): x, id(xv): xv}.values()]
    err = max(errs)
    dtype = str(x.dtype).split(".")[-1]
    require(err <= tol, f"K1 {site} {dtype}: max|err| {err} > {tol}")
    wk = w.to(x.dtype)    # timed in x's dtype, as a model in it holds w
    kernel = lambda: k1.fsmn_depthwise(x, wk, *pad, mask)  # noqa: E731
    ms = device_ms(torch, kernel)
    strided_ms = (None if xv is x else device_ms(
        torch, lambda: k1.fsmn_depthwise(xv, wk, *pad, mask)))
    host_ms = call_ms(torch, kernel)
    plain_ms = device_ms(
        torch, lambda: k1.fsmn_depthwise_plain(x, w, *pad, mask))
    library_ms = device_ms(torch, lambda: library(x, wk))
    el = x.element_size()

    def bound_of(rows: int):
        nbytes = ((x.numel() + b * rows * d + d * k) * el
                  + (0 if mask is None else mask.numel() * 4))
        return bound(nbytes, (2 * k + 2) * b * rows * d, peaks)
    bound_ms, bound_by = bound_of(t if kept is None else kept)
    row = dict(site=site, dtype=dtype, shape=[b, t, d, k], pad=list(pad),
               masked=mask is not None, tile=list(tile), max_abs_err=err,
               tol=tol, ms=ms, strided_ms=strided_ms, call_ms=host_ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=library_ms, launch_floor_ms=floor_ms)
    whole = ""
    if kept is not None:
        row["kept_rows"] = kept
        row["bound_whole_call_ms"] = bound_of(t)[0]
        whole = (f" for the {kept} kept rows ({t} computed: "
                 f"{row['bound_whole_call_ms'] * 1e3:.2f} us)")
    strided = ("" if strided_ms is None else
               f"strided view of [{b},{t},{xv.stride(1)}] "
               f"{strided_ms * 1e3:.2f} us, ")
    print(f"K1 fsmn_conv {site} {dtype} x[{b},{t},{d}] K={k} pad={pad} "
          f"{'masked' if mask is not None else 'no mask'} {tile}: max|err| "
          f"{err:.3g} (tol {tol}) device: kernel {ms * 1e3:.2f} us, "
          f"{strided}plain {plain_ms * 1e3:.2f} us, library "
          f"{library_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
          f"({bound_by}){whole}, launch floor {floor_ms * 1e3:.2f} us; per call "
          f"with host overhead {host_ms * 1e3:.2f} us", flush=True)
    return row


def conv_plus_x(pad):
    """The library yardstick of a length-preserving K1 call: one
    `F.conv1d(groups=D)` (its own padding when the pad is symmetric, an
    `F.pad` before it when not) and the residual add."""
    import torch.nn.functional as F

    def library(x, w):
        xt = x.transpose(1, 2)
        if pad[0] == pad[1]:
            y = F.conv1d(xt, w, padding=pad[0], groups=x.shape[-1])
        else:
            y = F.conv1d(F.pad(xt, pad), w, groups=x.shape[-1])
        return x + y.transpose(1, 2)
    return library


def check_k1(torch, peaks, floor_ms: float):
    """K1 against its plain version (f32: max|err| 0, the kernel repeats the
    plain roundings; bf16: 1e-2, one output rounding) on the contiguous
    input and, in the encoder, on the strided V view the path passes."""
    rows = []
    for site in K1_SITES:
        for dtype, tol in ((torch.float32, 0.0), (torch.bfloat16, 1e-2)):
            xv, w, mask = k1_case(torch, site, dtype, seed=1)
            rows.append(k1_measure(torch, peaks, floor_ms, site, xv, w,
                                   K1_PAD, mask, tol, conv_plus_x(K1_PAD)))
    return rows


# K1 and K2 at the streaming path's shapes (f32, as the path runs)
STREAM_S = 64                 # sessions of the largest bucket timed
VAD_CTX, VAD_T, VAD_D, VAD_K = 19, 40, 128, 20   # [cache ‖ h], lorder 20


def check_streaming_kernels(torch, peaks, floor_ms: float):
    """K1 in the chunked encoder (the V third of an [S, 9, 1536] qkv
    buffer, K 11, no mask) at S 64 and 1, and in FSMN-VAD's streaming step
    ([cache ‖ h] = [64, 19 + 40, 128], K 20, pad (19, 0), of which the path
    keeps rows 19 onward; yardstick: the reference's h + valid conv); K2 on
    the fused step's audio ring [64, 4320] → 25 frames and on the first
    0.4 s VAD tick [64, 6400] → 38 frames."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    rows = []
    w = torch.randn((512, 1, 11), generator=g, device=dev) * 0.02
    for s in (STREAM_S, 1):
        qkv = torch.randn((s, 9, 1536), generator=g, device=dev)
        rows.append(k1_measure(torch, peaks, floor_ms, f"stream_encoder_S{s}",
                               qkv[..., 1024:], w, (5, 5), None, 0.0,
                               conv_plus_x((5, 5))))
    hc = torch.randn((STREAM_S, VAD_CTX + VAD_T, VAD_D), generator=g,
                     device=dev)
    wv = torch.randn((VAD_D, 1, VAD_K), generator=g, device=dev) * 0.02

    def valid_conv_plus_h(x, wk):
        y = F.conv1d(x.transpose(1, 2), wk, groups=x.shape[-1])
        return x[:, VAD_CTX:] + y.transpose(1, 2)

    from toolbox_for_asr_and_tts_tpu_torch.ops.kernels import fsmn_conv as k1
    got = k1.fsmn_depthwise(hc, wv, VAD_CTX, 0)[:, VAD_CTX:]
    lib_err = k1_err(torch, got, valid_conv_plus_h(hc, wv))
    require(lib_err <= 1e-5, f"K1 VAD slice vs h + valid conv: {lib_err}")
    row = k1_measure(torch, peaks, floor_ms, "stream_vad", hc, wv,
                     (VAD_CTX, 0), None, 0.0, valid_conv_plus_h, kept=VAD_T)
    row["slice_vs_valid_conv_err"] = lib_err
    rows.append(row)
    k2_rows = [check_k2(torch, peaks, STREAM_S, 4320, 25, "stream_ring"),
               check_k2(torch, peaks, STREAM_S, 6400, 38, "stream_vad_tick")]
    return rows, k2_rows


# K1 and K2 at the service slice's shapes (f32, as the path runs)
CT_SHAPES = ((1, 32), (8, 64))   # punctuate groups: (batch, length bucket)
KWS_T, KWS_D, KWS_K, KWS_PAD = 53, 64, 12, (9, 2)   # 1.6 s → 53 LFR frames
KWS_WINDOW, KWS_FRAMES = 25600, 158
SV_WINDOWS = 16                  # the diarizer's 1 s windows per embed


def check_service_kernels(torch, peaks, floor_ms: float):
    """K1 in the CT-Transformer (the V third of a [B, T, 1536] qkv buffer,
    K 11, pad (5, 5), a length mask) at [1, 32] and [8, 64], and in the KWS
    DFSMN ([64, 53, 64], K 12 = lorder 10 + rorder 2, pad (9, 2), no
    mask); K2 on the KWS batch of 64 1.6 s windows → 158 frames and on
    the speaker embed of the diarizer's 1 s windows (16 of them, the pow-2
    count a finalize of a few seconds gives) → 98 frames."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    rows = []
    w = torch.randn((512, 1, 11), generator=g, device=dev) * 0.02
    for b, t in CT_SHAPES:
        qkv = torch.randn((b, t, 1536), generator=g, device=dev)
        lens = torch.tensor([t - 7 * (i % 3) for i in range(b)], device=dev)
        mask = (torch.arange(t, device=dev)[None] < lens[:, None]).float()
        rows.append(k1_measure(torch, peaks, floor_ms, f"ct_b{b}_t{t}",
                               qkv[..., 1024:], w, (5, 5), mask, 0.0,
                               conv_plus_x((5, 5))))
    h = torch.randn((64, KWS_T, KWS_D), generator=g, device=dev)
    wk = torch.randn((KWS_D, 1, KWS_K), generator=g, device=dev) * 0.02
    rows.append(k1_measure(torch, peaks, floor_ms, "kws", h, wk, KWS_PAD,
                           None, 0.0, conv_plus_x(KWS_PAD)))
    k2_rows = [check_k2(torch, peaks, 64, KWS_WINDOW, KWS_FRAMES,
                        "kws_batch"),
               check_k2(torch, peaks, SV_WINDOWS, SR, None, "sv_embed")]
    return rows, k2_rows


def sweep_k1(torch):
    """K1's device time for each tile (frames per thread x channels per
    block x K fixed at 11 or not; the wrapper's threads along T for each) at
    both sites and dtypes, on the input the main path passes; every tile is
    first held against the plain version."""
    from toolbox_for_asr_and_tts_tpu_torch.ops.kernels import fsmn_conv as k1
    for site in K1_SITES:
        for dtype, tol in ((torch.float32, 0.0), (torch.bfloat16, 1e-2)):
            x, w, mask = k1_case(torch, site, dtype, seed=3)
            wk = w.to(dtype).contiguous()
            want = k1.fsmn_depthwise_plain(x, w, *K1_PAD, mask)
            chosen = k1.tile_for(x, K1_K)
            times = {}
            for frames in (2, 4, 8):
                for channels in (32, 64, 128, 256, 512):
                    for k_const in (0, K1_K):
                        tile = k1.make_tile(x.shape[1], K1_K, chosen.vec,
                                            frames, channels, k_const)

                        def fn(tile=tile):
                            return k1.launch(x, wk, K1_PAD[0], mask, tile)

                        err = k1_err(torch, fn(), want)
                        require(err <= tol, f"K1 sweep {tile}: max|err| {err}")
                        times[tile] = device_ms(torch, fn)
            best = min(times, key=times.get)
            print(f"K1 sweep {site} {str(dtype).split('.')[-1]} "
                  f"x{list(x.shape)} strides {x.stride()}: best {best} "
                  f"{times[best] * 1e3:.2f} us, chosen {chosen} "
                  f"{times[chosen] * 1e3:.2f} us", flush=True)
            for tile, ms in sorted(times.items(), key=lambda kv: kv[1]):
                print(f"  frames {tile.frames} channels {tile.channels:3d} "
                      f"threads_t {tile.threads_t:3d} k_const "
                      f"{tile.k_const:2d}: {ms * 1e3:.2f} us")


def check_k2(torch, peaks, b: int = 8, n: int = 10 * SR, t=None,
             site: str = "offline"):
    """K2 against its plain version on [b, n] audio at the ×32768 scale
    (rtol 1e-5, atol 1e-5·max|x|: only the mean's summation order
    differs), t frames (default: all that fit)."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.ops import frontend as fe
    from toolbox_for_asr_and_tts_tpu_torch.ops.kernels import frame_window as k2
    cfg = fe.FrontendConfig()
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    audio = torch.from_numpy(
        (0.3 * rng.standard_normal((b, n)) * 32768.0)
        .astype(np.float32)).to(dev)
    win = torch.from_numpy(fe._window_coeffs(cfg)).to(dev)
    t = fe.num_fbank_frames(n, cfg) if t is None else t
    args = (audio, win, t, cfg.frame_length, cfg.frame_shift, cfg.n_fft,
            cfg.preemphasis, cfg.remove_dc_offset)
    got = k2.frame_window(*args)
    want = k2.frame_window_plain(*args)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = 1e-5 * audio.abs().max().item()
    rel = ((got - want).abs() - 1e-5 * want.abs()).max().item()
    require(rel <= tol, f"K2 {site}: max|err| {err} beyond rtol 1e-5, "
                        f"atol {tol}")
    ms = device_ms(torch, lambda: k2.frame_window(*args))
    host_ms = call_ms(torch, lambda: k2.frame_window(*args))
    plain_ms = device_ms(torch, lambda: k2.frame_window_plain(*args))
    nbytes = audio.numel() * 4 + win.numel() * 4 + got.numel() * 4
    flops = 6 * b * t * cfg.frame_length
    bound_ms, bound_by = bound(nbytes, flops, peaks)
    print(f"K2 frame_window {site} audio[{b},{n}] -> [{b},{t},{cfg.n_fft}]: "
          f"max|err| {err:.3g} (rtol 1e-5, atol {tol:.3g}) device: kernel "
          f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by}), library: none; per call "
          f"with host overhead {host_ms * 1e3:.2f} us", flush=True)
    return dict(site=site, shape=[b, n, t, cfg.n_fft], max_abs_err=err,
                ms=ms, call_ms=host_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


# ------------------------------------------------------ phase 3: main path
def make_wavs():
    """Speech-like rows: a few drifting harmonics plus noise, with pauses."""
    import numpy as np
    rng = np.random.default_rng(0)
    wavs = []
    for secs in ROW_SECONDS:
        n = int(secs * SR)
        t = np.arange(n) / SR
        f0 = 120 + 80 * np.sin(2 * np.pi * 0.3 * t + rng.uniform(0, 6))
        phase = 2 * np.pi * np.cumsum(f0) / SR
        x = sum(0.2 / h * np.sin(h * phase) for h in range(1, 6))
        x = x * (0.5 + 0.5 * np.sin(2 * np.pi * 1.7 * t) ** 2)
        x = x + 0.02 * rng.standard_normal(n)
        x[int(0.4 * n): int(0.45 * n)] *= 0.01
        wavs.append(x.astype(np.float32))
    return wavs


def counted(torch, fn):
    """Run fn with both launch counters zeroed just before it and read just
    after it: (result, K1 launches, K2 launches)."""
    from toolbox_for_asr_and_tts_tpu_torch.ops.kernels import fsmn_conv as k1
    from toolbox_for_asr_and_tts_tpu_torch.ops.kernels import frame_window as k2
    torch.cuda.synchronize()
    k1.launches = 0
    k2.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, k1.launches, k2.launches


def check_results(res, wavs, cfg):
    import numpy as np
    require(len(res) == len(wavs), "one result per row")
    for i, r in enumerate(res):
        n = len(r.token_ids)
        require(len(r.timestamps_ms) == n and len(r.timestamp) == n,
                f"row {i}: {n} tokens but {len(r.timestamps_ms)} timestamps")
        require(all(0 <= t < cfg.vocab_size for t in r.token_ids),
                f"row {i}: token id out of range")
        require(abs(r.audio_s - len(wavs[i]) / SR) < 1e-3, "audio_s")
        require(np.isfinite(r.rtf) and r.rtf > 0, "rtf")
    require(len(res[0].token_ids) > 0, "the 10 s row fired no token")


def hotwords_for(reco, res):
    toks = reco.tokenizer.tokens
    ids = res[0].token_ids
    return {toks[ids[0]] + toks[ids[1] % 8000 + 4]: 20,
            toks[ids[2]] + toks[ids[3]]: -10}


def main_path(torch, card, profile: bool):
    from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import Recognizer
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer import ParaformerConfig
    cfg = ParaformerConfig()
    t0 = time.perf_counter()
    reco = Recognizer.random(cfg, seed=0)           # the card, by default
    torch.cuda.synchronize()
    print(f"main path: Recognizer.random(ParaformerConfig(), seed=0) on "
          f"{reco.device} in {time.perf_counter() - t0:.1f} s "
          f"(encoder {cfg.encoder_layers}, decoder {cfg.decoder_layers}+1, "
          f"d {cfg.d_model}, ffn {cfg.ffn_dim}, vocab {cfg.vocab_size})",
          flush=True)
    wavs = make_wavs()
    audio_s = sum(len(w) for w in wavs) / SR
    warm = reco.transcribe(wavs)                    # library handles, plans
    hw = hotwords_for(reco, warm)
    reco.transcribe(wavs, hotwords=hw)

    res, k1_n, k2_n = counted(torch, lambda: reco.transcribe(wavs))
    check_results(res, wavs, cfg)
    print(f"launches per transcribe (no hotwords): K1 {k1_n}, K2 {k2_n}",
          flush=True)
    require(k1_n >= cfg.encoder_layers + cfg.decoder_layers,
            f"K1 launched {k1_n} times")
    require(k2_n == 1, f"K2 launched {k2_n} times")
    res_hw, k1_hw, k2_hw = counted(
        torch, lambda: reco.transcribe(wavs, hotwords=hw))
    check_results(res_hw, wavs, cfg)
    print(f"launches per transcribe (hotwords {sorted(hw)}): K1 {k1_hw}, "
          f"K2 {k2_hw}", flush=True)
    require(k1_hw >= cfg.encoder_layers + 2 * cfg.decoder_layers,
            f"K1 launched {k1_hw} times with rescoring")
    require(k2_hw == 1, f"K2 launched {k2_hw} times with rescoring")
    for i in (0, 1, 2):
        print(f"  row {i} ({ROW_SECONDS[i]} s): {len(res[i].token_ids)} "
              f"tokens, first ids {res[i].token_ids[:8]}, spans "
              f"{res[i].timestamp[:2]}")

    rtf = {}
    for name, kw in (("plain", {}), ("hotwords", {"hotwords": hw})):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            reco.transcribe(wavs, **kw)
            times.append(time.perf_counter() - t0)
        rtf[name] = statistics.median(times) / audio_s
        print(f"RTF batch 8 ({audio_s:.1f} s audio, {name}): "
              f"{rtf[name]:.6f} (median of 5, "
              f"{statistics.median(times) * 1e3:.1f} ms) on {card}",
              flush=True)
    if profile:
        profile_transcribe(torch, reco, wavs, rtf["plain"] * audio_s * 1e3)
        time_rescoring(torch, reco, wavs)
    return reco, wavs, {"K1": k1_n, "K2": k2_n, "K1_rescoring": k1_hw,
                        "K2_rescoring": k2_hw}, rtf


def profile_transcribe(torch, reco, wavs, wall_ms: float):
    """Device time of one transcribe by kernel (torch.profiler), against
    the unprofiled wall time of the same call."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        reco.transcribe(wavs)
        torch.cuda.synchronize()
    rows = _device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    require(busy_ms > 0, "profiler saw no device time")
    print(f"profile: one transcribe, device busy {busy_ms:.1f} ms of "
          f"{wall_ms:.1f} ms unprofiled wall (idle share "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%)")
    counts = {name: sum(e.count for e in rows if name in e.key)
              for name in ("elementwise", "copy")}
    print(f"profile: {sum(e.count for e in rows)} kernel launches, "
          f"{counts['elementwise']} of them elementwise kernels "
          f"({counts['copy']} copies)")
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:15]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms "
              f"{e.count:5d}x  {e.key[:90]}")


def time_rescoring(torch, reco, wavs):
    """Phase 2 of a hotword transcribe, part by part: the re-decode on the
    card, the bf16 logits fetch, and the host's float64 log-softmax."""
    import numpy as np
    from scipy.special import log_softmax
    batch, lens = reco.bucketer.pad_batch(wavs)
    dev = reco.forward_padded(batch, lens)
    counts = dev["token_count"].cpu().numpy()
    k_b = min(-(-int(counts.max()) // reco.K_BUCKET) * reco.K_BUCKET,
              dev["embeds"].shape[1])
    parts = {"decode": [], "fetch": [], "log_softmax": []}
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = reco.rescoring_logits(dev["embeds"], dev["token_count"],
                                       dev["enc"], dev["feat_lens"], k_b)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        arr = logits.float().cpu().numpy()
        t2 = time.perf_counter()
        for i, n in enumerate(counts):
            log_softmax(arr[i, :n].astype(np.float64), axis=-1)
        t3 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[key].append(dt * 1e3)
    print("rescoring phase 2 (median of 5): " + ", ".join(
        f"{k} {statistics.median(v):.1f} ms" for k, v in parts.items())
        + f" (k_b {k_b}, logits {tuple(logits.shape)} bf16)")


def compare_cpu(torch, reco, wavs):
    """The card's forward pass vs the same port on the CPU, rows CPU_ROWS."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import Recognizer
    cpu = Recognizer.random(reco.cfg, seed=0, device="cpu")
    batch, lens = reco.bucketer.pad_batch([wavs[i] for i in CPU_ROWS])
    t0 = time.perf_counter()
    a = {k: v.cpu() for k, v in reco.forward_padded(batch, lens).items()}
    b = cpu.forward_padded(batch, lens)
    print(f"cpu comparison: rows {list(CPU_ROWS)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    count = b["token_count"].numpy()
    require((a["token_count"].numpy() == count).all(),
            f"token_count card {a['token_count'].tolist()} cpu {count.tolist()}")
    logits = b["logits"].double().numpy()
    top2 = np.sort(logits, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    valid = np.arange(logits.shape[1])[None] < count[:, None]
    same = a["tokens"].numpy() == b["tokens"].numpy()
    decisive = valid & (gap > 1e-3)
    share = same[valid].mean() if valid.any() else 1.0
    require(same[decisive].all(), "tokens differ where the top-2 gap > 1e-3")
    require(share >= 0.999, f"only {share:.4%} of tokens equal")
    # fire frames may differ only where the CPU cumsum sits within 1e-4 of
    # the token boundary the two runs placed differently
    al = b["alphas"].double().numpy()
    tail = np.full((al.shape[0], 1), reco.cfg.predictor_tail_threshold)
    csum = np.cumsum(np.concatenate([al, tail], axis=1), axis=1)
    fa, fb = a["fire_frame"].numpy(), b["fire_frame"].numpy()
    near = 0
    for r, k in zip(*np.nonzero(valid & (fa != fb))):
        lo = min(fa[r, k], fb[r, k])
        require(abs(csum[r, lo] - (k + 1)) < 1e-4,
                f"row {r} token {k}: fire frame {fa[r, k]} vs {fb[r, k]} "
                f"with cumsum {csum[r, lo]:.6f} far from {k + 1}")
        near += 1
    dlog = np.abs(a["logits"].double().numpy() - logits).max()
    dal = np.abs(a["alphas"].double().numpy() - al).max()
    denc = np.abs(a["enc"].double().numpy() - b["enc"].double().numpy()).max()
    print(f"card vs cpu: token_count {count.tolist()} equal; tokens equal "
          f"{same[valid].sum()}/{valid.sum()} ({share:.4%}), "
          f"{(~same[valid]).sum()} differ (all with top-2 gap <= 1e-3); "
          f"fire frames differing near a boundary: {near}; "
          f"max|dlogit| {dlog:.3g}, max|dalpha| {dal:.3g}, max|denc| "
          f"{denc:.3g}", flush=True)


# ------------------------------------------------ phase 4: streaming path
CHUNK = 6400                  # the WebSocket protocol's 0.4 s chunk
STEP_S = 0.24                 # audio one chunked step consumes (c1 = 4)
STREAM_SIZES = (1, 16, 64)    # live sessions per run
COMPARE_SESSIONS = (0, 1)     # of the S = 16 run, held against references


def session_audio(n: int, seed: int):
    """n sessions of speech-like audio, 3.2-8.0 s each in whole 0.4 s
    chunks: a few drifting harmonics plus noise, with a pause."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        samples = CHUNK * int(rng.integers(8, 21))
        t = np.arange(samples) / SR
        f0 = 110 + 90 * np.sin(2 * np.pi * rng.uniform(0.2, 0.5) * t
                               + rng.uniform(0, 6))
        phase = 2 * np.pi * np.cumsum(f0) / SR
        x = sum(0.2 / h * np.sin(h * phase) for h in range(1, 6))
        x = x * (0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(1, 3) * t) ** 2)
        x = x + 0.02 * rng.standard_normal(samples)
        x[samples // 2: samples // 2 + 3200] *= 0.01
        out.append(x.astype(np.float32))
    return out


def drive_chunked(asr, audios):
    """Join one session per audio, feed every session its 0.4 s chunks
    tick by tick, then finalize each and leave. Returns (per-tick (wall s,
    steps, every session fed), per-session ids from the ticks, per-session
    ids from the finalize drains)."""
    slots = [asr.join() for _ in audios]
    back = {s: i for i, s in enumerate(slots)}
    ids = {i: [] for i in range(len(audios))}
    finals = {i: [] for i in range(len(audios))}
    ticks = []
    for c in range(max(len(a) for a in audios) // CHUNK):
        chunks = {slots[i]: a[c * CHUNK:(c + 1) * CHUNK]
                  for i, a in enumerate(audios) if (c + 1) * CHUNK <= len(a)}
        steps = asr.steps
        t0 = time.perf_counter()
        fired = asr.tick(chunks)            # ends in the fetch of its outputs
        ticks.append((time.perf_counter() - t0, asr.steps - steps,
                      len(chunks) == len(audios)))
        for s, v in fired.items():
            ids[back[s]].extend(v)
    for i, s in enumerate(slots):
        for s2, v in asr.finalize_slot(s).items():
            finals[back[s2]].extend(v)
    for s in slots:
        asr.leave(s)
    return ticks, ids, finals


def step_stats(ticks):
    """Median and p95 per-step wall time (ms) over the ticks after the
    first, a tick's wall split evenly over its steps; all ticks, and those
    in which every session was fed."""
    import numpy as np

    def stats(sel):
        per = [w / n * 1e3 for w, n, _ in sel for _ in range(n) if n]
        if not per:
            return None
        return dict(median_ms=float(np.median(per)),
                    p95_ms=float(np.percentile(per, 95)), steps=len(per))
    rest = ticks[1:]
    return stats(rest), stats([t for t in rest if t[2]])


def profile_steps(torch, asr, audios, n_ticks: int = 3):
    """Card busy time per step (torch.profiler) over n_ticks ticks of fresh
    sessions, against those ticks' unprofiled-like wall."""
    from torch.profiler import ProfilerActivity, profile
    slots = [asr.join() for _ in audios]
    asr.tick({s: a[:CHUNK] for s, a in zip(slots, audios)})    # warm-up
    steps = asr.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for c in range(1, 1 + n_ticks):
            asr.tick({s: a[c * CHUNK:(c + 1) * CHUNK]
                      for s, a in zip(slots, audios)})
        torch.cuda.synchronize()
    for s in slots:
        asr.leave(s)
    rows = _device_events(prof)
    n = asr.steps - steps
    busy = sum(e.self_device_time_total for e in rows) / 1e3 / n
    launches = sum(e.count for e in rows) / n
    require(busy > 0, "profiler saw no device time in the streaming steps")
    rows.sort(key=lambda e: -e.self_device_time_total)
    print(f"profile: {len(audios)} sessions, per step: busy {busy:.3f} ms, "
          f"{launches:.1f} launches; top kernels per step:")
    for e in rows[:10]:
        print(f"  {e.self_device_time_total / 1e3 / n:8.3f} ms "
              f"{e.count / n:7.1f}x  {e.key[:90]}")
    return dict(busy_ms_per_step=busy, launches_per_step=launches, steps=n)


def streaming_path(torch, card, params, profile: bool):
    """The chunked online Paraformer at full width through
    `BatchedChunkedASR(capacity=64, partials=True)` on the card, for S = 1,
    16 and 64 live sessions; then `BatchedVadTicker` on S = 64."""
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer import ParaformerConfig
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer_online import OnlineConfig
    from toolbox_for_asr_and_tts_tpu_torch.parallel.stream_batcher import (
        BatchedChunkedASR)
    cfg, ocfg = ParaformerConfig(), OnlineConfig()
    t0 = time.perf_counter()
    asr = BatchedChunkedASR(params, cfg, ocfg, capacity=64, partials=True)
    asr.warm()                         # every pow-2 prefix once, all masked
    torch.cuda.synchronize()
    print(f"streaming: BatchedChunkedASR(ParaformerConfig(), OnlineConfig(), "
          f"capacity=64, partials=True) on {asr.device}, warmed in "
          f"{time.perf_counter() - t0:.1f} s (chunk [{ocfg.c0}, {ocfg.c1}, "
          f"{ocfg.c2}], window {ocfg.window}, k/v cache {ocfg.kv_frames})",
          flush=True)
    out, compare_ids = {}, {}
    for n in STREAM_SIZES:
        audios = session_audio(n, seed=100 + n)
        steps_before = asr.steps
        (ticks, ids, finals), k1_n, k2_n = counted(
            torch, lambda: drive_chunked(asr, audios))
        n_steps = asr.steps - steps_before   # feeding ticks and finalize drains
        steps = sum(t[1] for t in ticks)
        require(n_steps > steps, f"S={n}: {n_steps} steps, {steps} feeding")
        require(k1_n == cfg.encoder_layers * n_steps and k2_n == n_steps,
                f"S={n}: K1 launched {k1_n} times and K2 {k2_n} times in "
                f"{n_steps} steps")
        every, all_live = step_stats(ticks)
        tokens = sum(len(v) for v in ids.values())
        require(tokens > 0, f"S={n}: no token fired")
        for i, v in ids.items():
            require(all(0 <= t < cfg.vocab_size for t in v + finals[i]),
                    f"S={n} session {i}: token id out of range")
        row = dict(sessions=n, audio_s=sum(len(a) for a in audios) / SR,
                   steps=n_steps, feed_steps=steps,
                   k1_per_step=k1_n / n_steps, k2_per_step=k2_n / n_steps,
                   step=every, step_all_live=all_live,
                   rt_share=every["median_ms"] / 1e3 / STEP_S,
                   tokens=tokens,
                   final_tokens=sum(len(v) for v in finals.values()))
        if profile:
            row["profile"] = profile_steps(torch, asr,
                                           session_audio(n, seed=200 + n))
        out[f"S{n}"] = row
        print(f"streaming S={n}: {n_steps} steps ({steps} feeding, the rest "
              f"finalize drains), K1 {k1_n} ({k1_n / n_steps:g}/step), K2 "
              f"{k2_n} ({k2_n / n_steps:g}/step); step wall median "
              f"{every['median_ms']:.2f} ms, p95 {every['p95_ms']:.2f} ms "
              f"(all {n} live: {all_live}); real-time share "
              f"{row['rt_share']:.4f}; {tokens} tokens fired, "
              f"{row['final_tokens']} in finalize"
              + (f"; profile {row['profile']}" if profile else "")
              + f" on {card}", flush=True)
        if n == 16:
            compare_ids = {i: ids[i] for i in COMPARE_SESSIONS}
            compare_audio = [audios[i] for i in COMPARE_SESSIONS]
    out["vad"] = vad_path(torch, card)
    return out, compare_ids, compare_audio


def vad_path(torch, card):
    """BatchedVadTicker(FsmnVadConfig(), capacity=64) on S = 64 sessions of
    0.4 s chunks: tick wall time and launches per tick."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.models import fsmn_vad as fv
    from toolbox_for_asr_and_tts_tpu_torch.parallel.stream_batcher import (
        BatchedVadTicker)
    cfg = fv.FsmnVadConfig()
    vad = BatchedVadTicker(fv.init_params(cfg, torch.Generator().manual_seed(0)),
                           cfg, capacity=64)
    audios = session_audio(64, seed=164)
    slots = [vad.join() for _ in audios]

    def run():
        walls, decisions = [], 0
        for c in range(max(len(a) for a in audios) // CHUNK):
            chunks = {s: a[c * CHUNK:(c + 1) * CHUNK]
                      for s, a in zip(slots, audios) if (c + 1) * CHUNK <= len(a)}
            t0 = time.perf_counter()
            res = vad.tick(chunks)
            walls.append(time.perf_counter() - t0)
            decisions += sum(res.values())
        return walls, decisions

    (walls, speech), k1_n, k2_n = counted(torch, run)
    n = len(walls)
    require(k1_n == cfg.fsmn_layers * n and k2_n == n,
            f"VAD: K1 {k1_n}, K2 {k2_n} in {n} ticks")
    rest = [w * 1e3 for w in walls[1:]]
    row = dict(sessions=64, ticks=n, k1_per_tick=k1_n / n,
               k2_per_tick=k2_n / n, tick_median_ms=float(np.median(rest)),
               tick_p95_ms=float(np.percentile(rest, 95)),
               speech_decisions=int(speech))
    print(f"streaming VAD S=64: {n} ticks, K1 {k1_n / n:g}/tick, K2 "
          f"{k2_n / n:g}/tick; tick wall median {row['tick_median_ms']:.2f} "
          f"ms, p95 {row['tick_p95_ms']:.2f} ms; {speech} speech decisions "
          f"on {card}", flush=True)
    return row


def run_direct(torch, device, params, audios):
    """The sessions on `device` through the halves of the ticker's step,
    `paraformer_online.fused_encode` then `fused_decode`, as one batch of
    len(audios) rows fed 0.24 s per step (rows that ended are fed silence,
    and two silence steps close the run, as `finalize_slot` pads); and each
    session through its own `StreamingFrontend` and
    `fsmn_vad.apply_streaming` in 0.4 s chunks. Returns per step the f32
    fired embeddings, fired counts, logits and token mask, and per VAD
    chunk the posteriors and the speech decision."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.models import fsmn_vad as fv
    from toolbox_for_asr_and_tts_tpu_torch.models import paraformer_online as po
    from toolbox_for_asr_and_tts_tpu_torch.models.convert import tree_to
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer import ParaformerConfig
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer_streaming import (
        StreamingFrontend)
    cpu = lambda t: t.detach().float().cpu()   # noqa: E731
    cfg, ocfg = ParaformerConfig(), po.OnlineConfig()
    a = ocfg.c1 * cfg.frontend.lfr_n * cfg.frontend.frame_shift
    n_steps = -(-max(len(x) for x in audios) // a) + 2
    audio = np.zeros((len(audios), n_steps * a), np.float32)
    for i, x in enumerate(audios):
        audio[i, :len(x)] = x
    p = tree_to(params, device)
    vcfg = fv.FsmnVadConfig()
    vp = tree_to(fv.init_params(vcfg, torch.Generator().manual_seed(0)), device)
    steps, vad = [], []
    with torch.inference_mode():
        st = po.init_fused_state(cfg, ocfg, len(audios), True, device)
        for s in range(n_steps):
            chunk = torch.from_numpy(audio[:, s * a:(s + 1) * a]).to(device)
            st, enc, emb, n = po.fused_encode(p, st, chunk, cfg, ocfg,
                                              k_cap=ocfg.tokens_per_chunk)
            st, logits, mask = po.fused_decode(p, st, enc, emb, n, cfg, ocfg)
            steps.append((cpu(emb), n.cpu(), cpu(logits), mask.cpu()))
        for x in audios:
            front = StreamingFrontend(vcfg.frontend, None, device)
            cache = fv.init_cache(1, vcfg, device)
            for c in range(0, len(x), CHUNK):
                feats = front.push(x[c:c + CHUNK])
                if len(feats):
                    post, cache = fv.apply_streaming(
                        vp, torch.from_numpy(feats[None]).to(device), cache,
                        vcfg)
                    speech = bool((fv.speech_prob(post, vcfg) > 0.5).any())
                    vad.append((cpu(post), speech))
    return steps, vad


def compare_streaming(torch, params, compare_ids, compare_audio):
    """Sessions COMPARE_SESSIONS of the S = 16 run: (a) their ticker ids
    equal a per-session OnlineRecognizer(partial_mode="incremental") on the
    card; (b) the same sessions through the ticker step's halves and the
    streaming VAD (`run_direct`) on the card and on the CPU, full width:
    fired counts equal, f32 embeddings within 1e-3, ids equal wherever the
    CPU's top-2 logit gap exceeds 1e-3; VAD decisions equal and posteriors
    within 1e-4."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.asr.tokenizer import CharTokenizer
    from toolbox_for_asr_and_tts_tpu_torch.models import paraformer_online as po
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer import ParaformerConfig
    cfg = ParaformerConfig()
    for i, audio in zip(COMPARE_SESSIONS, compare_audio):
        reco = po.OnlineRecognizer(params, cfg, CharTokenizer.dummy(
            cfg.vocab_size), po.OnlineConfig(), partial_mode="incremental")
        for c in range(0, len(audio), CHUNK):
            reco.push_audio(audio[c:c + CHUNK])
        require(reco._inc_ids == compare_ids[i],
                f"session {i}: ticker ids {compare_ids[i]} vs per-session "
                f"recognizer {reco._inc_ids}")
    print(f"streaming: ticker ids of sessions {list(COMPARE_SESSIONS)} of the "
          f"S=16 run equal per-session OnlineRecognizer(incremental) on the "
          f"card ({[len(compare_ids[i]) for i in COMPARE_SESSIONS]} tokens)",
          flush=True)
    t0 = time.perf_counter()
    card, card_vad = run_direct(torch, torch.device("cuda"), params,
                                compare_audio)
    cpu, cpu_vad = run_direct(torch, torch.device("cpu"), params, compare_audio)
    emb_err, tokens, same, differ = 0.0, 0, 0, 0
    for (ea, na, la, ma), (eb, nb, lb, mb) in zip(card, cpu):
        require(torch.equal(na, nb), f"fired counts {na.tolist()} vs "
                                     f"{nb.tolist()}")
        require(torch.equal(ma, mb), "decode token masks differ")
        for r, n in enumerate(nb.tolist()):
            if n:
                emb_err = max(emb_err, (ea[r, :n] - eb[r, :n]).abs().max().item())
                tokens += n
        valid = mb.bool().numpy()
        top2 = np.sort(lb.double().numpy(), axis=-1)[..., -2:]
        gap = top2[..., 1] - top2[..., 0]
        eq = (la.argmax(-1) == lb.argmax(-1)).numpy()
        require((eq | ~valid | (gap <= 1e-3)).all(),
                "ids differ where the top-2 gap > 1e-3")
        same += int((eq & valid).sum())
        differ += int((~eq & valid).sum())
    require(tokens > 0, "no token fired in the card-vs-CPU run")
    require(emb_err <= 1e-3, f"fired embeddings differ by {emb_err}")
    require(len(card_vad) == len(cpu_vad) > 0, "VAD chunk counts differ")
    require([s for _, s in card_vad] == [s for _, s in cpu_vad],
            "VAD decisions differ")
    post_err = max((a - b).abs().max().item()
                   for (a, _), (b, _) in zip(card_vad, cpu_vad))
    require(post_err <= 1e-4, f"VAD posteriors differ by {post_err}")
    row = dict(sessions=list(COMPARE_SESSIONS), steps=len(card), fired=tokens,
               max_abs_embed_err=emb_err, ids_equal=same, ids_differ=differ,
               vad_chunks=len(card_vad),
               vad_speech=sum(s for _, s in card_vad),
               vad_max_abs_post_err=post_err,
               seconds=time.perf_counter() - t0)
    print(f"streaming card vs cpu (fused_encode + fused_decode, "
          f"{len(card)} steps of {len(compare_audio)} rows): fired counts "
          f"equal ({tokens} tokens), max|dembed| {emb_err:.3g}; ids equal "
          f"{same}, differ {differ} (all with top-2 gap <= 1e-3); VAD "
          f"decisions equal over {row['vad_chunks']} chunks "
          f"({row['vad_speech']} speech), max|dposterior| {post_err:.3g}",
          flush=True)
    return row


# ------------------------------------------------- phase 6: the service
SERVICE_SIZES = (1, 16)       # concurrent WebSocket sessions per run
SILENCE_CHUNKS = 6            # 2.4 s after the speech: finalize at 2.0 s
WS_PATH = "/api/v1/voice/asr/ws"
# answered MISSING_AUDIO_DATA, in order: one extra text frame and one error
# reply per chunk, which real clients do not cause (not every chunk gets a
# reply of its own, so arrival order alone cannot attribute replies)
MARKER = b'{"type": "chunk_end"}'


class RawWS:
    """A minimal RFC 6455 client over a socket (the card's machine has no
    `websockets`): the upgrade handshake, masked client frames, and a
    reader thread that answers pings and keeps every text message with its
    arrival time (`time.perf_counter`)."""

    def __init__(self, port: int, timeout: float = 300.0,
                 path: str = WS_PATH):
        import base64
        import socket
        import threading
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall(
            (f"GET {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
             "Upgrade: websocket\r\nConnection: Upgrade\r\n"
             f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n"
             ).encode())
        head = b""
        while b"\r\n\r\n" not in head:      # byte by byte: no frame is eaten
            head += self._read(1)
        status = head.split(b"\r\n", 1)[0]
        require(b" 101 " in status + b" ", f"WS upgrade refused: {status!r}")
        self.messages = []                  # [(t, dict)]
        self.cond = threading.Condition()
        self._send_lock = threading.Lock()
        self.error = None
        self.reader = threading.Thread(target=self._read_loop, daemon=True)
        self.reader.start()

    def _read(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            got = self.sock.recv(n - len(out))
            if not got:
                raise ConnectionError("connection closed")
            out += got
        return out

    def _read_loop(self) -> None:
        import struct
        try:
            while True:
                h = self._read(2)
                n = h[1] & 0x7F
                if n == 126:
                    n = struct.unpack(">H", self._read(2))[0]
                elif n == 127:
                    n = struct.unpack(">Q", self._read(8))[0]
                payload = self._read(n)
                op = h[0] & 0x0F
                if op == 0x9:
                    self.send(0xA, payload)
                elif op == 0x8:
                    code = struct.unpack(">H", payload[:2])[0] if payload \
                        else None
                    self.error = ConnectionError(
                        f"closed by the server (code {code})")
                    return
                elif op == 0x1:
                    msg = json.loads(payload)
                    with self.cond:
                        self.messages.append((time.perf_counter(), msg))
                        self.cond.notify_all()
        except (ConnectionError, OSError) as e:
            self.error = e
        finally:
            with self.cond:
                self.cond.notify_all()

    def send(self, opcode: int, payload: bytes) -> float:
        """One masked frame; returns the time it was handed to the socket."""
        import struct
        import numpy as np
        mask = os.urandom(4)
        n = len(payload)
        hdr = bytes([0x80 | opcode])
        if n < 126:
            hdr += bytes([0x80 | n])
        elif n < 1 << 16:
            hdr += bytes([0x80 | 126]) + struct.pack(">H", n)
        else:
            hdr += bytes([0x80 | 127]) + struct.pack(">Q", n)
        body = (np.frombuffer(payload + b"\0" * (-n % 4), np.uint32)
                ^ np.frombuffer(mask, np.uint32)[0]).tobytes()[:n]
        with self._send_lock:
            t = time.perf_counter()
            self.sock.sendall(hdr + mask + body)
        return t

    def wait_for(self, pred, timeout: float) -> None:
        """Block until pred(messages) holds."""
        end = time.perf_counter() + timeout
        with self.cond:
            while not pred(self.messages):
                left = end - time.perf_counter()
                require(left > 0 and self.error is None,
                        f"WS: no expected reply within {timeout} s "
                        f"(error {self.error!r}); got "
                        f"{[m for _, m in self.messages][-4:]}")
                self.cond.wait(min(left, 1.0))

    def close(self) -> None:
        import struct
        try:
            self.send(0x8, struct.pack(">H", 1000))
        except OSError:
            pass
        self.sock.close()
        self.reader.join(timeout=10)


def pcm(x) -> bytes:
    import numpy as np
    return np.clip(np.round(x * 32768.0), -32768, 32767).astype(
        "<i2").tobytes()


def wav_b64(x) -> str:
    import base64
    from toolbox_for_asr_and_tts_tpu_torch.utils.audio import encode_wav_bytes
    return base64.b64encode(encode_wav_bytes(x, SR)).decode()


def drive_ws(port: int, steps, pace_s: float = CHUNK / SR):
    """One WebSocket session: the welcome, then each step — ("pcm", chunk)
    as a binary frame, ("json", obj) as a text frame — each followed by
    MARKER, whose MISSING_AUDIO_DATA reply closes the step's replies (the
    app answers a connection's frames in order). Audio steps are paced in
    real time. Returns (welcome, [(t_send, step kind, [(t, reply)])])."""
    ws = RawWS(port)
    try:
        ws.wait_for(lambda m: len(m) >= 1, 60)
        welcome = ws.messages[0][1]
        sent = []
        t0 = time.perf_counter()
        n_audio = 0
        for kind, obj in steps:
            if kind == "pcm":
                delay = t0 + n_audio * pace_s - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                n_audio += 1
                t = ws.send(0x2, pcm(obj))
            else:
                t = ws.send(0x1, json.dumps(obj).encode())
            ws.send(0x1, MARKER)
            sent.append((t, kind))

        def done(msgs):
            return sum(m.get("code") == "MISSING_AUDIO_DATA"
                       for _, m in msgs) >= len(steps)
        ws.wait_for(done, 300)
    finally:
        ws.close()
    groups, cur = [], []
    for t, m in ws.messages[1:]:
        if m.get("code") == "MISSING_AUDIO_DATA":
            groups.append(cur)
            cur = []
        else:
            cur.append((t, m))
    return welcome, [(ts, kind, g) for (ts, kind), g in zip(sent, groups)]


def utterance_steps(audio, flags):
    """The first 0.4 s chunk as JSON with the session flags and its audio
    (base64 WAV), the rest as binary PCM, then 2.4 s of silence."""
    import numpy as np
    chunks = [audio[i:i + CHUNK] for i in range(0, len(audio), CHUNK)]
    chunks += [np.zeros(CHUNK, np.float32)] * SILENCE_CHUNKS
    return ([("json", dict(flags, audio_data=wav_b64(chunks[0])))]
            + [("pcm", c) for c in chunks[1:]])


def utterance_stats(welcome, steps, what: str):
    """Require welcome → ≥ 1 partial → finalizing → result; return the
    partial latencies (send of a chunk → its `processing` message) and the
    finalize latency (send of the chunk that triggers it → `result`), s."""
    require(welcome.get("type") == "welcome", f"{what}: no welcome")
    partial, final, seen = [], None, set()
    for t_send, _, replies in steps:
        for t, m in replies:
            seen.add(m.get("type"))
            if m.get("type") == "error":
                raise PhaseError(f"{what}: error reply {m}")
            if m.get("type") == "processing" and m.get("intermediate_text"):
                partial.append(t - t_send)
            if m.get("type") == "result":
                final = t - t_send
                require(any(r.get("status") == "finalizing"
                            for _, r in replies),
                        f"{what}: result without finalizing in its step")
    require(partial, f"{what}: no processing message with a partial text")
    require(final is not None, f"{what}: no result ({sorted(seen)})")
    return partial, final


def quantiles(xs):
    import numpy as np
    return dict(median_ms=float(np.median(xs) * 1e3),
                p95_ms=float(np.percentile(xs, 95) * 1e3), n=len(xs))


def campplus_params(torch, cfg, seed: int):
    """CAM++ weights drawn from `seed` with non-trivial BatchNorm
    statistics and affines. The default stats (mean 0, variance 1) leave
    random-weight embeddings tiny, and a wrong conv or layout would then
    hide under any absolute tolerance."""
    from toolbox_for_asr_and_tts_tpu_torch.models import campplus
    g = torch.Generator().manual_seed(seed)

    def bn(tree):
        if isinstance(tree, list):
            return [bn(v) for v in tree]
        if not isinstance(tree, dict):
            return tree
        if "mean" not in tree or "var" not in tree:
            return {k: bn(v) for k, v in tree.items()}
        d = tree["mean"].shape[0]
        out = dict(tree, mean=0.3 * torch.randn(d, generator=g),
                   var=0.5 + 1.5 * torch.rand(d, generator=g))
        if "g" in tree:
            out.update(g=0.5 + torch.rand(d, generator=g),
                       b=0.2 * torch.randn(d, generator=g))
        return out
    return bn(campplus.init_params(cfg, torch.Generator().manual_seed(seed)))


def build_service(torch, reco):
    """The engines as `service/engines.py::build_engines` wires them, at full
    width on the card, the offline and online recognizers on `reco`'s
    weights: FinalizeHub over the Diarizer (Paraformer-large, CAM++ with
    random BatchNorm statistics, CT-Transformer large), KwsHub over the KWS, VadHub and ChunkedHub with
    64 rows. The KWS threshold fires on the first full window (-1e9); the
    model VAD's threshold 1.01 keeps its decision False (random weights
    would hold the enrollment's silence timer at 0) while its ticks still
    run on the card."""
    from toolbox_for_asr_and_tts_tpu_torch.asr.diarization import Diarizer
    from toolbox_for_asr_and_tts_tpu_torch.asr.session import VoiceEngines
    from toolbox_for_asr_and_tts_tpu_torch.asr.speaker import SpeakerVerifier
    from toolbox_for_asr_and_tts_tpu_torch.models.campplus import CampPlusConfig
    from toolbox_for_asr_and_tts_tpu_torch.models.ct_transformer import (
        CTTransformerConfig, Punctuator)
    from toolbox_for_asr_and_tts_tpu_torch.models.kws_ctc import (
        KeywordSpotter, KwsConfig)
    from toolbox_for_asr_and_tts_tpu_torch.service import engines as E
    from toolbox_for_asr_and_tts_tpu_torch.service import hub as H
    os.environ["VOICE_VAD_THRESHOLD"] = "1.01"
    t0 = time.perf_counter()
    sv = SpeakerVerifier(campplus_params(torch, CampPlusConfig(), 0),
                         CampPlusConfig())
    punc = Punctuator.random(CTTransformerConfig(), seed=0)
    kws = KeywordSpotter.random(KwsConfig(), seed=0, threshold=-1e9)
    engines = VoiceEngines(
        diarizer=H.FinalizeHub(Diarizer(reco, sv, punctuator=punc)),
        kws=H.KwsHub(kws), verifier=sv,
        vad_factory=E._vad_factory(capacity=64),
        streaming_factory=E._streaming_factory(reco, capacity=64))
    torch.cuda.synchronize()
    print(f"service: engines on {sv.device}, {punc.device}, {kws.device} "
          f"built in {time.perf_counter() - t0:.1f} s (ChunkedHub warmed at "
          f"every pow-2 occupancy to 64; CT-Transformer {punc.cfg.num_layers} "
          f"layers d {punc.cfg.d_model}, vocab {punc.cfg.vocab_size}; CAM++ "
          f"blocks {sv.cfg.block_layers}; KWS {kws.cfg.num_layers} FSMN "
          f"layers, proj {kws.cfg.proj_dim})", flush=True)
    return engines, (reco, sv, punc, kws)


def voice_app(engines):
    from toolbox_for_asr_and_tts_tpu_torch.runtime.config import VoiceConfig
    from toolbox_for_asr_and_tts_tpu_torch.service.voice_app import create_app
    return create_app(engines=engines, cfg=VoiceConfig(disable_llm=True))


class Server:
    """One of the port's apps (voice or TTS) served on 127.0.0.1 from a
    thread; `stop` shuts the server and the app's engines down."""

    def __init__(self, app):
        import asyncio
        import threading
        self.app = app
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(
            target=lambda: self.loop.run_until_complete(
                self.app.serve("127.0.0.1", 0)), daemon=True)
        self.thread.start()
        for _ in range(600):
            if getattr(self.app, "port", None):
                return
            time.sleep(0.05)
        raise PhaseError("the app did not start")

    def stop(self) -> None:
        import asyncio
        asyncio.run_coroutine_threadsafe(self.app.shutdown(),
                                         self.loop).result(60)
        self.thread.join(60)
        self.app.close_engines()
        self.loop.close()


def http_json(port: int, method: str, path: str, body: bytes = b""):
    import socket
    s = socket.create_connection(("127.0.0.1", port), timeout=300)
    try:
        s.sendall((f"{method} {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                   "Content-Type: application/json\r\n"
                   f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
        data = b""
        while b"\r\n\r\n" not in data:
            data += s.recv(65536)
        head, rest = data.split(b"\r\n\r\n", 1)
        n = int(next(ln.split(b":")[1] for ln in head.split(b"\r\n")
                     if ln.lower().startswith(b"content-length")))
        while len(rest) < n:
            rest += s.recv(65536)
        return int(head.split()[1]), json.loads(rest[:n])
    finally:
        s.close()


def program_counts(engines, models):
    """The device programs that the service's models (`build_service`'s
    recognizer, verifier, punctuator and spotter) and its hubs' tickers
    have run so far, by their own counters."""
    reco, sv, punc, kws = models
    chunked = engines.streaming_factory.hub.ticker
    vad = engines.vad_factory.hub.ticker
    return dict(chunked_steps=chunked.steps, vad_steps=vad.steps,
                vad_fbanks=vad.fbanks, transcribes=reco.forwards.n,
                rescorings=reco.rescorings.n,
                punctuate_forwards=punc.forwards.n, embeds=sv.forwards.n,
                kws_forwards=kws.forwards.n, kws_fbanks=kws.fbanks.n)


def accounted(torch, what: str, engines, models, fn):
    """Run fn (one run of the served path) with both launch counters zeroed
    just before it and read just after, and require each kernel's launches
    to equal what the run's device programs launch: K1 once per layer of
    each chunked step (encoder), transcribe (encoder and decoder),
    rescoring (decoder), punctuate forward, KWS forward and VAD step; K2
    once per chunked step, transcribe, embed, KWS fbank and VAD fbank.
    Returns (fn's result, the run's program counts and launches)."""
    reco, _, punc, kws = models
    before = program_counts(engines, models)
    out, k1, k2 = counted(torch, fn)
    n = {k: v - before[k]
         for k, v in program_counts(engines, models).items()}
    enc, dec = reco.cfg.encoder_layers, reco.cfg.decoder_layers
    want_k1 = (enc * n["chunked_steps"] + (enc + dec) * n["transcribes"]
               + dec * n["rescorings"]
               + punc.cfg.num_layers * n["punctuate_forwards"]
               + kws.cfg.num_layers * n["kws_forwards"]
               + engines.vad_factory.hub.ticker.cfg.fsmn_layers
               * n["vad_steps"])
    want_k2 = (n["chunked_steps"] + n["transcribes"] + n["embeds"]
               + n["kws_fbanks"] + n["vad_fbanks"])
    print(f"service {what}: K1 {k1} launches (expected {want_k1}), K2 {k2} "
          f"(expected {want_k2}); programs {n}", flush=True)
    require(k1 == want_k1 and k2 == want_k2,
            f"{what}: K1 {k1} launches for {want_k1} expected, K2 {k2} for "
            f"{want_k2}")
    require(k1 > 0 and k2 > 0, f"{what}: K1 {k1}, K2 {k2} launches")
    return out, dict(n, k1=k1, k2=k2)


def sessions_run(torch, port: int, engines, models, n: int):
    """n concurrent sessions (use_wake and use_sv off) of 3.2-8 s speech and
    2.4 s silence, 0.4 s chunks paced in real time, launches accounted."""
    import threading
    audios = session_audio(n, seed=300 + n)
    out = [None] * n
    errors = []

    def one(i):
        try:
            out[i] = drive_ws(port, utterance_steps(
                audios[i], {"use_wake": False, "use_sv": False}))
        except BaseException as e:   # reported by the caller
            errors.append(e)

    def run():
        threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()

    t0 = time.perf_counter()
    _, launches = accounted(torch, f"S={n}", engines, models, run)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    partial, final = [], []
    for i, (welcome, steps) in enumerate(out):
        p, f = utterance_stats(welcome, steps, f"S={n} session {i}")
        partial += p
        final.append(f)
    row = dict(sessions=n, audio_s=sum(len(a) for a in audios) / SR,
               wall_s=wall, partial=quantiles(partial),
               finalize=quantiles(final), launches=launches)
    print(f"service S={n}: partial latency median "
          f"{row['partial']['median_ms']:.1f} ms, p95 "
          f"{row['partial']['p95_ms']:.1f} ms ({len(partial)} partials); "
          f"finalize latency median {row['finalize']['median_ms']:.1f} ms, "
          f"p95 {row['finalize']['p95_ms']:.1f} ms; "
          f"{launches['chunked_steps']} chunked steps, "
          f"{launches['vad_steps']} VAD steps (the model VAD runs in "
          f"enrollment only) in {wall:.1f} s", flush=True)
    return row


def four_mode_session(torch, port: int, engines, models):
    """wake → wakeup → enrollment (5.2 s speech, 2.4 s silence) →
    enrollment_completed → start_asr → asr_started → one utterance with
    use_sv → result. The KWS runs through KwsHub, CAM++ at finalize (the
    enrollment embedding and the speakers' segments), the model VAD in
    enrollment. Launches accounted."""
    import numpy as np
    speech = session_audio(3, seed=400)
    wake = np.concatenate(speech)[: 4 * CHUNK]
    enroll = np.concatenate(speech)[4 * CHUNK: 17 * CHUNK]
    silence = [np.zeros(CHUNK, np.float32)] * SILENCE_CHUNKS
    steps = ([("pcm", wake[i:i + CHUNK]) for i in range(0, len(wake), CHUNK)]
             + [("pcm", enroll[i:i + CHUNK])
                for i in range(0, len(enroll), CHUNK)]
             + [("pcm", c) for c in silence]
             + [("json", {"type": "start_asr"})]
             + utterance_steps(speech[2], {"use_sv": True}))
    (welcome, got), launches = accounted(torch, "four modes", engines,
                                         models, lambda: drive_ws(port, steps))
    order = ["welcome"]
    for _, _, replies in got:
        for _, m in replies:
            require(m.get("type") != "error", f"four-mode: error reply {m}")
            order.append(m.get("type") if m.get("type") != "status"
                         else m.get("status"))
    require(welcome.get("mode") == "WAITING_FOR_WAKEUP", f"welcome {welcome}")
    want = ["welcome", "wakeup", "enrollment_completed", "asr_started"]
    seq = [o for o in order if o in want + ["result"]]
    require(seq[:4] == want and seq[-1] == "result",
            f"four-mode session replies {order}")
    result = next(m for _, _, r in got for _, m in r
                  if m.get("type") == "result")
    row = dict(replies=order, result=result, launches=launches)
    print(f"service four modes: {' → '.join(o for o in order if o != 'processing')}"
          f"; result {result}", flush=True)
    require(launches["kws_forwards"] >= 1 and launches["vad_steps"] >= 1
            and launches["embeds"] >= 2,
            "the KWS, the model VAD or CAM++ (enrollment and finalize) "
            "never ran")
    return row


def rest_check(torch, port: int, engines, models):
    """POST /api/v1/voice/asr with an 8 s WAV (use_wake off), launches
    accounted: the text equals apply_hard_corrections of the port's
    Diarizer.diarize on the same decoded audio, called directly on the
    card."""
    from toolbox_for_asr_and_tts_tpu_torch.asr.corrections import (
        apply_hard_corrections)
    from toolbox_for_asr_and_tts_tpu_torch.utils.audio import base64_to_audio_np
    b64 = wav_b64(make_wavs()[5][: 8 * SR])
    t0 = time.perf_counter()
    (status, out), launches = accounted(
        torch, "REST", engines, models,
        lambda: http_json(port, "POST", "/api/v1/voice/asr", json.dumps(
            {"audio_data": b64, "use_wake": False}).encode()))
    wall = time.perf_counter() - t0
    require(status == 200 and out.get("success"), f"REST: {status} {out}")
    sents = engines.diarizer.inner.diarize(base64_to_audio_np(b64))
    direct = apply_hard_corrections("".join(s.text for s in sents))
    require(out["text"] == direct,
            f"REST text {out['text']!r} vs direct diarize {direct!r}")
    status, bad = http_json(port, "POST", "/api/v1/voice/asr", b"{}")
    require(status == 422, f"REST without audio_data: {status} {bad}")
    print(f"service REST: 8 s WAV in {wall * 1e3:.1f} ms, text of "
          f"{len(out['text'])} chars equals the direct diarize "
          f"({len(sents)} sentences); a body without audio_data → 422",
          flush=True)
    return dict(wall_ms=wall * 1e3, chars=len(out["text"]),
                sentences=len(sents), launches=launches)


def service_launches(torch, sv, punc, kws):
    """Per-call figures beside the served runs' own accounting: launches
    around direct calls, K1 per punctuate forward, K1 and K2 per KWS batch
    (one length group of 64 windows), K2 per embed."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.models.ct_transformer import (
        split_words)
    rng = np.random.default_rng(7)
    words = split_words("".join(chr(0x4E00 + int(c))
                                for c in rng.integers(0, 20000, 20)))
    _, k1_p, k2_p = counted(torch, lambda: punc.classify(words))
    windows = [w[:KWS_WINDOW] for w in session_audio(64, seed=500)]
    _, k1_k, k2_k = counted(torch, lambda: kws.detect_audio_batch(windows))
    wavs = [w[: int(s * SR)] for w, s in zip(make_wavs(), (3.0, 2.2, 1.4))]
    _, k1_e, k2_e = counted(torch, lambda: sv.embed(wavs))
    row = dict(k1_per_punctuate_forward=k1_p, k2_per_punctuate_forward=k2_p,
               k1_per_kws_batch=k1_k, k2_per_kws_batch=k2_k,
               k1_per_embed=k1_e, k2_per_embed=k2_e)
    print(f"service launches: punctuate forward K1 {k1_p} K2 {k2_p}; KWS "
          f"batch of 64 K1 {k1_k} K2 {k2_k}; embed of 3 K1 {k1_e} K2 {k2_e}",
          flush=True)
    require(k1_p == punc.cfg.num_layers and k2_p == 0,
            f"punctuate: K1 {k1_p}, K2 {k2_p}")
    require(k1_k == kws.cfg.num_layers and k2_k == 1,
            f"KWS batch: K1 {k1_k}, K2 {k2_k}")
    require(k2_e == 1 and k1_e == 0, f"embed: K1 {k1_e}, K2 {k2_e}")
    return row


def service_card_vs_cpu(torch, sv, punc, kws):
    """The port at full width on both devices: punctuation class ids equal
    on 2 sentences; CAM++ (random BatchNorm statistics) embeddings within
    1e-5·max|e| with cosine ≥ 0.9999; KWS scores within 1e-3."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.asr.speaker import SpeakerVerifier
    from toolbox_for_asr_and_tts_tpu_torch.models.convert import tree_to
    from toolbox_for_asr_and_tts_tpu_torch.models.ct_transformer import (
        Punctuator, split_words)
    from toolbox_for_asr_and_tts_tpu_torch.models.kws_ctc import KeywordSpotter
    t0 = time.perf_counter()
    rng = np.random.default_rng(8)
    cpu_punc = Punctuator(tree_to(punc.params, torch.device("cpu")),
                          punc.cfg, punc.vocab, device="cpu")
    sentences = [split_words("".join(chr(0x4E00 + int(c))
                                     for c in rng.integers(0, 20000, n)))
                 for n in (14, 40)]
    punc_equal = 0
    for words in sentences:
        a, b = punc.classify(words), cpu_punc.classify(words)
        require((a == b).all(), f"punctuation ids card {a} cpu {b}")
        punc_equal += len(words)
    del cpu_punc
    cpu_sv = SpeakerVerifier(tree_to(sv.params, torch.device("cpu")), sv.cfg,
                             device="cpu")
    wavs = [w[: int(s * SR)] for w, s in zip(make_wavs(), (4.0, 2.5))]
    ea, eb = sv.embed(wavs), cpu_sv.embed(wavs)
    emb_max = float(np.abs(eb).max())
    emb_err = float(np.abs(ea - eb).max())
    cos = min(float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))
              for a, b in zip(ea, eb))
    require(np.isfinite(ea).all() and emb_max > 0,
            f"CAM++ embeddings: max|e| {emb_max}")
    require(emb_err <= 1e-5 * emb_max and cos >= 0.9999,
            f"CAM++ card vs cpu: max|d| {emb_err} (max|e| {emb_max}), "
            f"cosine {cos}")
    cpu_kws = KeywordSpotter.random(kws.cfg, seed=0, threshold=kws.threshold,
                                    device="cpu")
    windows = [w[:KWS_WINDOW] for w in session_audio(4, seed=600)]
    sa = [s for _, s in kws.detect_audio_batch(windows)]
    sb = [s for _, s in cpu_kws.detect_audio_batch(windows)]
    kws_err = max(abs(a - b) for a, b in zip(sa, sb))
    require(kws_err <= 1e-3, f"KWS scores card {sa} cpu {sb}")
    row = dict(punctuation_ids_equal=punc_equal, campplus_max_abs=emb_max,
               campplus_max_abs_err=emb_err,
               campplus_min_cosine=cos, kws_max_abs_score_err=kws_err,
               seconds=time.perf_counter() - t0)
    print(f"service card vs cpu: punctuation ids equal on {punc_equal} words "
          f"(2 sentences); CAM++ max|dembed| {emb_err:.3g} of max|e| "
          f"{emb_max:.3g} (limit 1e-5·max|e|), min cosine "
          f"{cos:.7f}; KWS max|dscore| {kws_err:.3g} over 4 windows",
          flush=True)
    return row


def profile_service(torch, port: int, engines, models, n: int = 16):
    """The card's busy time over a second S = n run (torch.profiler, all
    threads), against that run's wall: the service's idle share."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        row = sessions_run(torch, port, engines, models, n)
        torch.cuda.synchronize()
    rows = _device_events(prof)
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    require(busy > 0, "profiler saw no device time in the service run")
    wall_ms = row["wall_s"] * 1e3
    rows.sort(key=lambda e: -e.self_device_time_total)
    print(f"profile: service S={n}, card busy {busy:.1f} ms of "
          f"{wall_ms:.1f} ms wall (idle share "
          f"{100 * (1 - busy / wall_ms):.1f}%), "
          f"{sum(e.count for e in rows)} kernel launches; top kernels:")
    for e in rows[:10]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")
    return dict(busy_ms=busy, wall_ms=wall_ms,
                launches=sum(e.count for e in rows),
                partial=row["partial"], finalize=row["finalize"])


def service_path(torch, card, reco, profile: bool):
    """Phase 6: the voice service at full width on the card."""
    engines, models = build_service(torch, reco)
    _, sv, punc, kws = models
    server = Server(voice_app(engines))
    try:
        port = server.app.port
        out = {f"S{n}": sessions_run(torch, port, engines, models, n)
               for n in SERVICE_SIZES}
        out["four_modes"] = four_mode_session(torch, port, engines, models)
        out["rest"] = rest_check(torch, port, engines, models)
        if profile:
            out["profile_S16"] = profile_service(torch, port, engines,
                                                 models)
    finally:
        server.stop()
    out["launches"] = service_launches(torch, sv, punc, kws)
    out["card_vs_cpu"] = service_card_vs_cpu(torch, sv, punc, kws)
    return out, models


# ------------------------------------------------------ phase 7: TTS
# 14 segments at the service's targets (18 / 14 / 22): two batches of 8
TTS_TEXT = ("患者今年六十二岁，因反复胸闷气短三天来院就诊。入院后查血压一百五十比"
            "九十，心率八十八次每分钟，心电图提示窦性心律。医生建议低盐低脂饮食，"
            "适量运动，戒烟限酒，规律作息。请按时服用降压药物，每天早晚各测一次血压"
            "并做好记录。如果出现头晕头痛、胸痛或者呼吸困难，请立即拨打急救电话。下次"
            "复诊时间是两周以后的星期三上午，请带好病历和检查报告。祝您早日康复，生活"
            "愉快。")
TTS_WS_PATH = "/api/v1/tts/ws"
TTS_CPU_SEGMENTS = 2     # segments held against the CPU run
TTS_MEL_REL = 1e-4       # card vs CPU: mel max |Δ| ≤ this · max |mel|
TTS_PCM_LSB = 2          # card vs CPU: PCM within this many int16 steps
TTS_STREAM_LSB = 1       # stream vs one-shot on the card
PNCA_T_MELS = (96, 192)  # forward_ar at 32 and 64 steps: the step's cost


def tts_counted(torch, synth, fn):
    """fn with K1/K2's counters zeroed just before it and read just after,
    and the synthesizer's programs (duration probes, synth groups, PNCA
    steps, mel frames computed) over the same run."""
    tallies = ("probes", "synths", "ar_steps", "mel_frames")
    before = [getattr(synth, t).n for t in tallies]
    out, k1, k2 = counted(torch, fn)
    return out, dict({t: getattr(synth, t).n - b
                      for t, b in zip(tallies, before)}, k1=k1, k2=k2)


def hifigan_flops_per_frame(v) -> int:
    """Operations (2 per multiply-add) of HiFi-GAN per mel frame, from its
    config: conv_pre, per stage the ConvTranspose (C_in·C_out·K per input
    sample) and every resblock conv at the stage's rate, conv_post."""
    ch, rate = v.upsample_initial_channel, 1
    flops = 2 * v.n_mels * ch * 7
    for r, k in zip(v.upsample_rates, v.upsample_kernels):
        flops += 2 * ch * (ch // 2) * k * rate
        ch, rate = ch // 2, rate * r
        taps = sum(2 * rk * len(rd) for rk, rd in zip(v.resblock_kernels,
                                                      v.resblock_dilations))
        flops += 2 * ch * ch * taps * rate
    return flops + 2 * ch * 7 * rate


def tts_pin(synth, mode: str = "nar"):
    """The serving defaults, pinned whatever the environment says: the
    NAR decoder, one call per batch."""
    synth.decoder_mode = mode
    synth.group_by_length = synth.mel_group = False
    return synth


def tts_segments(synth):
    from toolbox_for_asr_and_tts_tpu_torch.tts.text_frontend import (
        split_text_for_tts)
    c = synth.cfg
    return split_text_for_tts(TTS_TEXT, c.seg_target, c.seg_first,
                              c.seg_hard_max)


def check_tts(synth, res, segments):
    """One result of `synthesize(TTS_TEXT)`: its segments, finite samples in
    [-1, 1], whole mel frames per segment, and a length that is the sum of
    the segments and pauses less one crossfade per boundary."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.tts.text_frontend import pause_after
    c = synth.cfg
    require(res.segments == segments, "segments differ from the split")
    require(np.isfinite(res.wav).all() and np.abs(res.wav).max() <= 1.0,
            "samples not finite or outside [-1, 1]")
    hop = synth.vcfg.hop_length
    n = [round(d * SR) for d in res.seg_durations_s]
    require(all(k > 0 and k % hop == 0 for k in n),
            f"segment lengths {n} not whole mel frames")
    pauses = sum(int(SR * pause_after(s, c.pause_soft_ms, c.pause_hard_ms)
                     / 1000) for s in segments[:-1])
    fade = int(SR * c.crossfade_ms / 1000)
    want = sum(n) + pauses - fade * (len(n) - 1)
    require(len(res.wav) == want, f"{len(res.wav)} samples, {want} expected")


def pcm16(wav):
    import numpy as np
    return np.round(np.asarray(wav, np.float64) * 32767.0).astype(np.int64)


def tts_one_shot(torch, card, synth, segments):
    """One warm-up, then the median of 3 `synthesize` calls: wall, audio
    seconds, RTF, and each run's programs (K1 and K2 must not launch);
    every run's PCM must equal the warm-up's (synthesis is deterministic)."""
    bs = synth.cfg.batch_size
    batches = -(-len(segments) // bs)
    first = pcm16(synth.synthesize(TTS_TEXT).wav)   # cuDNN plans, handles
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        res, n = tts_counted(torch, synth, lambda: synth.synthesize(TTS_TEXT))
        wall = time.perf_counter() - t0
        check_tts(synth, res, segments)
        import numpy as np
        require(np.array_equal(pcm16(res.wav), first),
                "two syntheses of one text differ")
        require(n["k1"] == 0 and n["k2"] == 0,
                f"the TTS path launched K1 {n['k1']}, K2 {n['k2']} times")
        require(n["probes"] == batches and n["synths"] == batches,
                f"programs {n}: one probe and one synth per batch of {bs} "
                f"expected ({batches} batches)")
        runs.append(dict(wall_ms=wall * 1e3, audio_s=len(res.wav) / SR,
                         rtf=wall / (len(res.wav) / SR), programs=n))
    mid = sorted(runs, key=lambda r: r["wall_ms"])[1]
    frames = mid["programs"]["mel_frames"]
    gflop = frames * hifigan_flops_per_frame(synth.vcfg) / 1e9
    f32_peak = card_peaks(card)[1]
    print(f"tts one-shot: {len(segments)} segments in {batches} batches of "
          f"<= {bs}, {mid['audio_s']:.3f} s of audio, wall "
          f"{mid['wall_ms']:.1f} ms (median of 3: "
          f"{[round(r['wall_ms'], 1) for r in runs]}), RTF {mid['rtf']:.5f}; "
          f"programs per call {mid['programs']}; PCM of the 4 calls equal; "
          f"HiFi-GAN {gflop:.1f} GFLOP per call over {frames} mel frames "
          f"(padding included), {gflop / f32_peak * 1e12:.2f} ms at the f32 "
          f"peak, on {card}", flush=True)
    return res, dict(segments=len(segments), batches=batches,
                     wall_ms=mid["wall_ms"], audio_s=mid["audio_s"],
                     rtf=mid["rtf"], runs=runs,
                     segment_seconds=res.seg_durations_s,
                     hifigan_gflop=gflop,
                     hifigan_f32_bound_ms=gflop / f32_peak * 1e12)


def tts_stream(torch, synth):
    """`synthesize_stream` under per-segment grouping (each segment in its
    own phone and mel bucket, where the stream's contract holds): time to
    the first chunk (one warm-up, median of 3) and its concatenation
    against `synthesize()` under the same grouping: equal length, the
    count of equal samples and the max |Δ| in int16 steps. (Under
    whole-batch grouping the first segment, alone in the stream, gets its
    own phone bucket and so its own mel cap: lengths may differ.)"""
    import numpy as np

    def run():
        t0 = time.perf_counter()
        first, chunks = None, []
        for ev in synth.synthesize_stream(TTS_TEXT):
            if first is None and ev["event"] == "chunk":
                first = time.perf_counter() - t0
            chunks.append(ev["audio"])
        return first * 1e3, (time.perf_counter() - t0) * 1e3, \
            np.concatenate(chunks)

    synth.group_by_length = synth.mel_group = True
    try:
        one_shot = synth.synthesize(TTS_TEXT)
        run()
        runs = [run() for _ in range(3)]
    finally:
        tts_pin(synth)
    ttfa = statistics.median(r[0] for r in runs)
    wall = statistics.median(r[1] for r in runs)
    got = runs[-1][2]
    require(len(got) == len(one_shot.wav),
            f"stream {len(got)} samples, one-shot {len(one_shot.wav)}")
    d = np.abs(pcm16(got) - pcm16(one_shot.wav))
    equal = int((d == 0).sum())
    print(f"tts stream (per-segment grouping): first audio after "
          f"{ttfa:.1f} ms (median of 3: {[round(r[0], 1) for r in runs]}), "
          f"whole stream {wall:.1f} ms; against one-shot: {equal} of "
          f"{len(d)} samples equal, max |d| {int(d.max())} LSB (limit "
          f"{TTS_STREAM_LSB})", flush=True)
    require(int(d.max()) <= TTS_STREAM_LSB,
            f"stream differs from one-shot by {int(d.max())} LSB")
    return dict(ttfa_ms=ttfa, wall_ms=wall, equal_samples=equal,
                samples=len(d), max_lsb=int(d.max()))


def tts_batch(synth, segments):
    """[b, l, 4] ids, lengths and speakers of `segments`, as
    `synthesize_segments` builds them (whole-batch grouping)."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.tts.text_frontend import (
        text_to_ling_ids)
    seqs = [text_to_ling_ids(s, synth.g2p, synth.vocab) for s in segments]
    l = synth.bucketer.bucket(max(len(q) for q in seqs))
    ids = np.zeros((len(seqs), l, 4), np.int32)
    for i, q in enumerate(seqs):
        ids[i, :len(q)] = q
    lens = np.asarray([len(q) for q in seqs], np.int32)
    return ids, lens, np.zeros(len(seqs), np.int32)


def tts_pnca(torch, card, synth, segments, profile: bool):
    """The PNCA decoder on one segment through `synthesize_segments` (wall,
    AR steps), then `forward_ar` alone at two mel lengths: the difference
    over the extra steps is the cost of one step (wall; launches under
    --profile)."""
    from toolbox_for_asr_and_tts_tpu_torch.models import sambert
    tts_pin(synth, "pnca")
    try:
        synth.synthesize_segments(segments[:1], "zhitian_emo")   # warm-up
        t0 = time.perf_counter()
        (wavs, _), n = tts_counted(
            torch, synth,
            lambda: synth.synthesize_segments(segments[:1], "zhitian_emo"))
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        tts_pin(synth, "nar")
    require(n["k1"] == 0 and n["k2"] == 0 and n["ar_steps"] > 0,
            f"pnca programs {n}")
    require(len(wavs[0]) > 0, "pnca gave no audio")
    ids, lens, spk = (torch.from_numpy(a).to(synth.device)
                      for a in tts_batch(synth, segments[:1]))

    def ar(t_mel):
        with torch.inference_mode():
            out = sambert.forward_ar(synth.ap, ids, lens, spk, synth.acfg,
                                     t_mel=t_mel)
        torch.cuda.synchronize()
        return out

    ar(PNCA_T_MELS[0])
    r = synth.acfg.outputs_per_step
    steps = [-(-t // r) for t in PNCA_T_MELS]
    walls = []
    for t in PNCA_T_MELS:
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            ar(t)
            ts.append((time.perf_counter() - t0) * 1e3)
        walls.append(statistics.median(ts))
    per_step = (walls[1] - walls[0]) / (steps[1] - steps[0])
    out = dict(segment=segments[0], ar_steps=n["ar_steps"], wall_ms=wall,
               ms_per_step_in_call=wall / n["ar_steps"],
               forward_ar_ms={str(t): w for t, w in zip(PNCA_T_MELS, walls)},
               ms_per_step=per_step)
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        launches = []
        for t in PNCA_T_MELS:
            with prof_ctx(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                ar(t)
            launches.append(sum(e.count for e in _device_events(prof)))
        out["launches"] = {str(t): k for t, k in zip(PNCA_T_MELS, launches)}
        out["launches_per_step"] = ((launches[1] - launches[0])
                                    / (steps[1] - steps[0]))
    print(f"tts pnca: one segment ({len(wavs[0]) / SR:.3f} s) in {wall:.1f} "
          f"ms, {n['ar_steps']} AR steps ({wall / n['ar_steps']:.3f} ms per "
          f"step of the call); forward_ar alone {out['forward_ar_ms']} ms at "
          f"t_mel {PNCA_T_MELS}: {per_step:.3f} ms per step"
          + (f", {out['launches_per_step']:.1f} launches per step "
             f"({out['launches']})" if profile else "") + f" on {card}",
          flush=True)
    return out


def tts_card_vs_cpu(torch, synth, segments):
    """The same weights on the CPU, TTS_CPU_SEGMENTS segments: duration
    probe, durations and mel lengths equal, mel within TTS_MEL_REL of its
    largest magnitude, PCM within TTS_PCM_LSB."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.models import sambert
    from toolbox_for_asr_and_tts_tpu_torch.tts.synthesizer import Synthesizer
    cpu = tts_pin(Synthesizer(synth.ap, synth.acfg, synth.vp, synth.vcfg,
                              device="cpu"))
    segs = segments[:TTS_CPU_SEGMENTS]
    arrays = tts_batch(synth, segs)
    l = arrays[0].shape[1]
    probe = [s._dur_fn(*s._to_device(*arrays)).cpu().numpy()
             for s in (synth, cpu)]
    require(np.array_equal(*probe), f"duration probes differ: {probe}")
    mb = synth.MEL_BUCKET
    t_mel = int(max(min(-(-probe[0].max() // mb) * mb,
                        l * synth.acfg.frames_per_phone), mb))
    outs = []
    for s in (synth, cpu):
        with torch.inference_mode():
            o = sambert.forward(s.ap, *s._to_device(*arrays), s.acfg,
                                t_mel=t_mel)
        outs.append({k: v.cpu().numpy() for k, v in o.items()})
    card_o, cpu_o = outs
    v = np.exp(cpu_o["log_duration"].astype(np.float64)) - 1.0
    valid = np.arange(l)[None, :] < arrays[1][:, None]
    margin = float(np.abs(v - np.floor(v) - 0.5)[valid].min())
    for k in ("durations", "mel_lens"):
        require(np.array_equal(card_o[k], cpu_o[k]),
                f"{k} differ between card and CPU (least distance of a "
                f"duration from a rounding tie {margin:.2e})")
    mel_scale = float(np.abs(cpu_o["mel"]).max())
    mel_err = float(np.abs(card_o["mel"] - cpu_o["mel"]).max())
    (w_card, _), (w_cpu, _) = (s.synthesize_segments(segs, "zhitian_emo")
                               for s in (synth, cpu))
    require([len(w) for w in w_card] == [len(w) for w in w_cpu],
            "segment lengths differ between card and CPU")
    lsb = max(int(np.abs(pcm16(a) - pcm16(c)).max())
              for a, c in zip(w_card, w_cpu))
    equal = sum(int((pcm16(a) == pcm16(c)).sum())
                for a, c in zip(w_card, w_cpu))
    total = sum(len(w) for w in w_card)
    print(f"tts card vs CPU ({len(segs)} segments, t_mel {t_mel}): probes "
          f"{probe[0].tolist()} equal, durations and mel lengths "
          f"{card_o['mel_lens'].tolist()} equal (least distance from a "
          f"rounding tie {margin:.2e}); mel max |d| {mel_err:.3e} of max "
          f"|mel| {mel_scale:.3f} (limit {TTS_MEL_REL:g} x); PCM {equal} of "
          f"{total} samples equal, max |d| {lsb} LSB (limit {TTS_PCM_LSB})",
          flush=True)
    require(mel_err <= TTS_MEL_REL * mel_scale,
            f"mel differs by {mel_err} (max |mel| {mel_scale})")
    require(lsb <= TTS_PCM_LSB, f"PCM differs by {lsb} LSB")
    return dict(segments=len(segs), t_mel=t_mel,
                mel_lens=card_o["mel_lens"].tolist(), tie_margin=margin,
                mel_max_abs_err=mel_err, mel_max_abs=mel_scale,
                pcm_max_lsb=lsb, pcm_equal=equal, pcm_samples=total)


def tts_service(torch, card, synth):
    """The port's TTS app over `synth` on 127.0.0.1: one REST job polled to
    `completed`, then the same text over the WebSocket, whose pcm16 chunks
    must equal the job's WAV samples exactly (the same programs on the same
    card). K1 and K2 must not launch."""
    import base64
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.runtime.config import TTSConfig
    from toolbox_for_asr_and_tts_tpu_torch.service.tts_app import create_app
    from toolbox_for_asr_and_tts_tpu_torch.utils.audio import decode_wav_bytes
    server = Server(create_app(synthesizer=synth, cfg=TTSConfig()))

    def run():
        port = server.app.port
        t0 = time.perf_counter()
        status, out = http_json(port, "POST", "/api/v1/tts/start",
                                json.dumps({"text": TTS_TEXT}).encode())
        require(status == 200, f"start: {status} {out}")
        for _ in range(1200):
            status, body = http_json(
                port, "GET", f"/api/v1/tts/result/{out['job_id']}")
            if body["status"] in ("completed", "error"):
                break
            time.sleep(0.05)
        rest_ms = (time.perf_counter() - t0) * 1e3
        require(body["status"] == "completed", f"job: {body}")
        wav, sr = decode_wav_bytes(base64.b64decode(body["audio_base64"]))
        job = np.round(wav[:, 0].astype(np.float64) * 32768.0).astype(np.int64)
        ws = RawWS(port, path=TTS_WS_PATH)
        try:
            sent = ws.send(0x1, json.dumps({"text": TTS_TEXT}).encode())
            ws.wait_for(lambda ms: any(m["type"] in ("done", "error")
                                       for _, m in ms), 300)
        finally:
            ws.close()
        msgs = ws.messages
        require(all(m["type"] != "error" for _, m in msgs),
                f"WS error: {[m for _, m in msgs if m['type'] == 'error']}")
        chunks = [(t, m) for t, m in msgs if m["type"] == "chunk"]
        pcm = np.concatenate([np.frombuffer(base64.b64decode(
            m["pcm16_base64"]), "<i2") for _, m in chunks]).astype(np.int64)
        require(len(pcm) == len(job) and np.array_equal(pcm, job),
                f"WS pcm16 ({len(pcm)} samples) differs from the job's WAV "
                f"({len(job)})")
        return dict(rest_ms=rest_ms, samples=len(job),
                    ws_first_chunk_ms=(chunks[0][0] - sent) * 1e3,
                    ws_done_ms=(msgs[-1][0] - sent) * 1e3,
                    ws_chunks=len(chunks))

    try:
        out, k1, k2 = counted(torch, run)
    finally:
        server.stop()
    require(k1 == 0 and k2 == 0, f"the TTS app launched K1 {k1}, K2 {k2}")
    out.update(k1=k1, k2=k2)
    print(f"tts service: REST job polled to completed in "
          f"{out['rest_ms']:.1f} ms; WS first chunk after "
          f"{out['ws_first_chunk_ms']:.1f} ms, done after "
          f"{out['ws_done_ms']:.1f} ms, {out['ws_chunks']} chunks whose "
          f"pcm16 equals the job's {out['samples']} samples on {card}",
          flush=True)
    return out


def profile_tts(torch, synth, wall_ms: float):
    """The card's busy time over one `synthesize` (torch.profiler) against
    its unprofiled wall time, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        synth.synthesize(TTS_TEXT)
        torch.cuda.synchronize()
    rows = _device_events(prof)
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    require(busy > 0, "profiler saw no device time in synthesize")
    rows.sort(key=lambda e: -e.self_device_time_total)
    launches = sum(e.count for e in rows)
    print(f"profile: tts synthesize, card busy {busy:.2f} ms of {wall_ms:.1f} "
          f"ms wall (idle share {100 * (1 - busy / wall_ms):.1f}%), "
          f"{launches} kernel launches; top kernels:")
    top = []
    for e in rows[:10]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")
        top.append([e.key[:90], e.self_device_time_total / 1e3, e.count])
    return dict(busy_ms=busy, wall_ms=wall_ms, launches=launches, top=top)


def tts_path(torch, card, profile: bool):
    """Phase 7: the TTS service at full width on the card."""
    from toolbox_for_asr_and_tts_tpu_torch.tts.synthesizer import Synthesizer
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    synth = tts_pin(Synthesizer.random(seed=0, tiny=False))  # the card
    torch.cuda.synchronize()
    a, v = synth.acfg, synth.vcfg
    print(f"tts: Synthesizer.random(seed=0, tiny=False) on {synth.device} in "
          f"{time.perf_counter() - t0:.1f} s (Sambert d {a.d_model}, "
          f"{a.encoder_layers} + {a.decoder_layers} layers, {a.pnca_layers} "
          f"PNCA layers, vocab {a.vocab_size}; HiFi-GAN "
          f"{v.upsample_initial_channel} channels, upsample "
          f"{v.upsample_rates}, hop {v.hop_length})", flush=True)
    segments = tts_segments(synth)
    require(len(segments) > synth.cfg.batch_size,
            f"{len(segments)} segments: one batch only")
    res, one_shot = tts_one_shot(torch, card, synth, segments)
    out = dict(one_shot=one_shot,
               stream=tts_stream(torch, synth),
               pnca=tts_pnca(torch, card, synth, segments, profile),
               card_vs_cpu=tts_card_vs_cpu(torch, synth, segments),
               service=tts_service(torch, card, synth))
    # K1 / K2 launches over the counted runs (one-shot and served); each
    # run required 0: the TTS path reaches neither kernel
    out["launches"] = {k: sum(r["programs"][k] for r in one_shot["runs"])
                       + out["service"][k] for k in ("k1", "k2")}
    if profile:
        out["profile"] = profile_tts(torch, synth, one_shot["wall_ms"])
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"tts phase: {out['phase_s']:.1f} s", flush=True)
    return out, synth


# ------------------------------------------ phase 8: mounted checkpoints
# Kaldi `am.mvn` of the mounted Paraformer: seeded vectors, fixed here so
# the loaded and the in-memory recognizer normalize alike
MVN_SEED = 8
MOUNT_VOICE = "zhitian_emo"
BN_EPS = 1e-5


def save_state_dict(torch, sd, path: str) -> int:
    """torch.save a numpy state dict (FunASR / KAN-TTS naming); its bytes."""
    import numpy as np
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, path)
    return os.path.getsize(path)


def write_json(path: str, obj) -> int:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f)
    return os.path.getsize(path)


def seeded_cmvn(dim: int):
    import numpy as np
    rng = np.random.default_rng(MVN_SEED)
    return (-rng.uniform(4.0, 12.0, dim).astype(np.float32),
            rng.uniform(0.15, 0.45, dim).astype(np.float32))


def write_mvn(path: str, cmvn) -> int:
    """Kaldi-nnet text form, values printed with 9 significant digits so
    the float32 vectors read back exactly."""
    dim = len(cmvn[0])
    vec = lambda a: " ".join(f"{v:.9g}" for v in a)  # noqa: E731
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"<Nnet>\n<Splice> {dim} {dim}\n[ 0 ]\n"
                f"<AddShift> {dim} {dim}\n<LearnRateCoef> 0 [ "
                f"{vec(cmvn[0])} ]\n<Rescale> {dim} {dim}\n"
                f"<LearnRateCoef> 0 [ {vec(cmvn[1])} ]\n</Nnet>\n")
    return os.path.getsize(path)


def bn_var_for_scale_2():
    """A float32 running variance whose var + eps is exactly 4.0, so the
    BatchNorm fold divides by exactly 2: the postnet written as BatchNorm
    (weight 2·g, bias b, running mean 0) folds back to g and b bit for
    bit."""
    import numpy as np
    v = np.float32(4.0 - BN_EPS)
    for _ in range(64):
        s = (np.array([v], np.float32) + BN_EPS)[0]
        if s == np.float32(4.0):
            return v
        v = np.nextafter(v, np.float32(np.inf if s < 4.0 else -np.inf),
                         dtype=np.float32)
    raise PhaseError("no float32 variance folds to a scale of exactly 2")


def weight_norm_fold(w):
    """torch's weight_norm of one conv weight, folded back on the host
    (g·v/‖v‖ with g = ‖v‖, the norm over every dim but 0), which rounds
    the last bit of some weights: the vocoder the package defines."""
    import numpy as np
    v = np.asarray(w, np.float32)
    norm = np.sqrt((v * v).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
    return (norm * v / np.maximum(norm, 1e-12)).astype(np.float32), norm


def write_mount(torch, root: str, reco, cmvn, sv, punc, kws, vad_params,
                synth):
    """One directory per family under the registry's names, each holding
    a full-width tree of the earlier phases in FunASR / KAN-TTS naming
    (`invert_to_state_dict`, torch.save), with config.json (read without
    PyYAML), token lists and am.mvn where the family reads them. The online Paraformer's directory is a symlink to the offline
    one. Returns the bytes written per family and the vocoder tree the
    package defines (its weight-norm pairs folded)."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.models.convert import tree_map
    from toolbox_for_asr_and_tts_tpu_torch.runtime import checkpoints as ckpt
    from toolbox_for_asr_and_tts_tpu_torch.runtime.registry import MODELS
    d = {k: os.path.join(root, MODELS[k].name) for k in MODELS}
    n = {}
    c = reco.cfg
    n["paraformer_offline"] = save_state_dict(
        torch, ckpt.invert_to_state_dict(reco.params, ckpt.paraformer_rules(
            c.encoder_layers, c.decoder_layers)),
        os.path.join(d["paraformer_offline"], "model.pt"))
    n["paraformer_offline"] += write_json(
        os.path.join(d["paraformer_offline"], "config.json"), {
            "model": "Paraformer",
            "encoder_conf": {"output_size": c.d_model,
                             "attention_heads": c.n_heads,
                             "linear_units": c.ffn_dim,
                             "num_blocks": c.encoder_layers,
                             "kernel_size": c.kernel_size,
                             "sanm_shift": c.sanm_shift},
            "decoder_conf": {"num_blocks": c.decoder_layers},
            "predictor_conf": {"tail_threshold":
                               c.predictor_tail_threshold},
            "frontend_conf": {"n_mels": 80, "lfr_m": c.lfr_m,
                              "lfr_n": c.lfr_n}})
    n["paraformer_offline"] += write_json(
        os.path.join(d["paraformer_offline"], "tokens.json"),
        reco.tokenizer.tokens)
    n["paraformer_offline"] += write_mvn(
        os.path.join(d["paraformer_offline"], "am.mvn"), cmvn)
    os.symlink(d["paraformer_offline"], d["paraformer_streaming"])

    n["sv"] = save_state_dict(torch, ckpt.invert_to_state_dict(
        sv.params, ckpt.campplus_rules(sv.cfg.block_layers)),
        os.path.join(d["sv"], "model.pt"))

    pc = punc.cfg
    n["punc"] = save_state_dict(torch, ckpt.invert_to_state_dict(
        punc.params, ckpt.ct_transformer_rules(pc.num_layers)),
        os.path.join(d["punc"], "model.pt"))
    n["punc"] += write_json(os.path.join(d["punc"], "config.json"), {
        "encoder_conf": {"attention_heads": pc.n_heads,
                         "linear_units": pc.ffn_dim,
                         "num_blocks": pc.num_layers,
                         "output_size": pc.d_model,
                         "input_size": pc.embed_dim,
                         "kernel_size": pc.kernel_size,
                         "sanm_shift": pc.sanm_shift},
        "model_conf": {"punc_list": list(pc.punc_list),
                       "vocab_size": pc.vocab_size}})
    n["punc"] += write_json(os.path.join(d["punc"], "tokens.json"),
                            punc.vocab.tokens)

    kc = kws.cfg
    n["kws"] = save_state_dict(torch, ckpt.invert_to_state_dict(
        kws.params, ckpt.kws_rules(kc.num_layers, kc.rorder)),
        os.path.join(d["kws"], "model.pt"))
    n["kws"] += write_json(os.path.join(d["kws"], "config.json"), {
        "encoder_conf": {"input_dim": kc.input_dim,
                         "input_affine_dim": kc.input_affine_dim,
                         "linear_dim": kc.hidden_dim,
                         "proj_dim": kc.proj_dim,
                         "fsmn_layers": kc.num_layers, "lorder": kc.lorder,
                         "rorder": kc.rorder,
                         "output_affine_dim": kc.output_affine_dim,
                         "output_dim": kc.vocab_size}})
    # line i is token id i: the keyword's ids (小 1, 护 2) as in memory
    toks = ["<blank>", "小", "护"] + [chr(0x4E00 + i)
                                     for i in range(2, kc.vocab_size - 1)]
    require([kws.char_to_id[ch] for ch in "小护"] == [1, 2],
            "the in-memory spotter's keyword ids")
    with open(os.path.join(d["kws"], "tokens.txt"), "w",
              encoding="utf-8") as f:
        f.write("".join(f"{t} {i}\n" for i, t in enumerate(toks)))
    n["kws"] += os.path.getsize(os.path.join(d["kws"], "tokens.txt"))

    from toolbox_for_asr_and_tts_tpu_torch.models.fsmn_vad import FsmnVadConfig
    vc = FsmnVadConfig()
    n["fsmn_vad"] = save_state_dict(torch, ckpt.invert_to_state_dict(
        vad_params, ckpt.fsmn_vad_rules(vc.fsmn_layers)),
        os.path.join(d["fsmn_vad"], "model.pt"))
    n["fsmn_vad"] += write_json(os.path.join(d["fsmn_vad"], "config.json"), {
        "encoder_conf": {"input_dim": vc.input_dim,
                         "input_affine_dim": vc.input_affine_dim,
                         "linear_dim": vc.linear_dim, "proj_dim": vc.proj_dim,
                         "fsmn_layers": vc.fsmn_layers, "lorder": vc.lorder,
                         "rorder": vc.rorder,
                         "output_affine_dim": vc.output_affine_dim,
                         "output_dim": vc.output_dim},
        "model_conf": {"sil_pdf_ids": list(vc.sil_pdf_ids)}})

    # the KAN-TTS package: Sambert's postnet as BatchNorm, HiFi-GAN as
    # weight-norm pairs, so both folds run at load
    a, v = synth.acfg, synth.vcfg
    am = ckpt.invert_to_state_dict(synth.ap, ckpt.sambert_rules(
        a.encoder_layers, a.pnca_layers, a.postnet_layers))
    var = bn_var_for_scale_2()
    for i in range(a.postnet_layers):
        base = f"mel_postnet.conv_stack.{i}.norm."
        g = am[base + "weight"]
        am[base + "weight"] = (g * np.float32(2.0)).astype(np.float32)
        am[base + "running_mean"] = np.zeros_like(g)
        am[base + "running_var"] = np.full_like(g, var)
    voc = ckpt.invert_to_state_dict(synth.vp, ckpt.hifigan_rules(
        len(v.upsample_rates), len(v.resblock_kernels),
        len(v.resblock_dilations[0])))
    for name in [k for k in voc if k.endswith(".weight")
                 and np.ndim(voc[k]) >= 2]:
        w = np.asarray(voc.pop(name), np.float32)
        voc[name[:-len("weight")] + "weight_v"] = w
        voc[name[:-len("weight")] + "weight_g"] = weight_norm_fold(w)[1]
    tts = d["tts"]
    n["tts"] = save_state_dict(torch, am, os.path.join(
        tts, f"voices/{MOUNT_VOICE}/am/ckpt/checkpoint_0.pth"))
    n["tts"] += write_json(
        os.path.join(tts, f"voices/{MOUNT_VOICE}/am/config.json"),
        {"Model": {"KanTtsSAMBERT": {"params": {
            "encoder_num_heads": a.n_heads,
            "outputs_per_step": a.outputs_per_step}}}})
    n["tts"] += save_state_dict(torch, voc, os.path.join(
        tts, f"voices/{MOUNT_VOICE}/voc/ckpt/checkpoint_0.pth"))
    n["tts"] += write_json(
        os.path.join(tts, f"voices/{MOUNT_VOICE}/voc/config.json"),
        {"Model": {"Generator": {"params": {
            "upsample_rates": list(v.upsample_rates),
            "resblock_dilation_sizes": [list(x) for x in
                                        v.resblock_dilations]}}}})
    vp_folded = tree_map(
        lambda t: torch.from_numpy(weight_norm_fold(t.cpu().numpy())[0])
        if t.dim() >= 2 else t.cpu(), synth.vp)
    return d, n, vp_folded


def cache_bytes(root: str) -> int:
    total = 0
    for dirpath, _, files in os.walk(root):
        total += sum(os.path.getsize(os.path.join(dirpath, f)) for f in files
                     if f.endswith((".torch.npz", ".torch.cfg.json"))
                     or f == "torch_params.npz")
    return total


def timed_loads(torch, load):
    """load() cold (converting, the cache written) and warm (from the
    cache), each ending in a synchronize: (warm result, cold s, warm s)."""
    times = []
    for _ in range(2):
        out = None          # the cold result is freed before the warm load
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = load()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, times[0], times[1]


def trees_equal(a, b, what: str) -> int:
    """Leaf for leaf, bit for bit; the number of leaves."""
    from toolbox_for_asr_and_tts_tpu_torch.runtime import checkpoints as ckpt
    fa, fb = ckpt.flatten_params(a), ckpt.flatten_params(b)
    require(sorted(fa) == sorted(fb), f"{what}: tree paths differ")
    bad = [k for k in fa if fa[k].shape != fb[k].shape
           or not (fa[k] == fb[k]).all()]
    require(not bad, f"{what}: {len(bad)} leaves differ, e.g. {bad[:3]}")
    return len(fa)


def profile_load(torch, model_dir: str, cfg):
    """--profile: the stages of one Paraformer-large conversion and one
    cache read (host clock; the checkpoint is memory-mapped, so its reads
    land in `convert`), into a cache file of its own that is removed."""
    from toolbox_for_asr_and_tts_tpu_torch.models import paraformer
    from toolbox_for_asr_and_tts_tpu_torch.models.convert import (
        params_from_numpy)
    from toolbox_for_asr_and_tts_tpu_torch.runtime import checkpoints as ckpt
    rules = ckpt.paraformer_rules(cfg.encoder_layers, cfg.decoder_layers)
    template = ckpt.shape_template(lambda g: paraformer.init_params(cfg, g))
    cache = os.path.join(model_dir, "profile_params.npz")
    t = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t[name] = time.perf_counter() - t0
        return out
    sd = stage("torch_load_mmap", lambda: ckpt.load_torch_state_dict(
        ckpt.find_checkpoint(model_dir)))
    params = stage("convert", lambda: ckpt.convert_state_dict(
        sd, rules, template))
    stage("cache_write", lambda: ckpt.save_converted(cache, params))
    del sd, params
    params = stage("cache_read", lambda: ckpt.load_converted(cache,
                                                             template))
    stage("to_card", lambda: params_from_numpy(params, "cuda"))
    os.unlink(cache)
    print("profile: Paraformer-large load stages " + ", ".join(
        f"{k} {v:.2f} s" for k, v in t.items()), flush=True)
    return t


def checkpoints_path(torch, card, root, reco, wavs, models, synth,
                     profile: bool):
    """Phase 8: every family written as a mounted checkpoint directory at
    full width under `root` (the caller removes it), then loaded from it
    (cold, converting; warm, from the cache) and held against the same
    weights built in memory: the recognizer's token ids and K1/K2
    launches, the voice service from `build_engines(model_dir=root)` behind
    `create_app` (REST text and speakers, direct embeddings, punctuation
    and KWS scores), and PNCA synthesis from the KAN-TTS package, sample
    for sample. Returns (figures, the mounted voice app's Server and
    engines, still serving for phase 9; the caller stops it)."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.asr.diarization import Diarizer
    from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import Recognizer
    from toolbox_for_asr_and_tts_tpu_torch.asr.speaker import SpeakerVerifier
    from toolbox_for_asr_and_tts_tpu_torch.asr.corrections import (
        apply_hard_corrections)
    from toolbox_for_asr_and_tts_tpu_torch.models import fsmn_vad
    from toolbox_for_asr_and_tts_tpu_torch.models.ct_transformer import (
        Punctuator, split_words)
    from toolbox_for_asr_and_tts_tpu_torch.models.kws_ctc import KeywordSpotter
    from toolbox_for_asr_and_tts_tpu_torch.service import engines as E
    from toolbox_for_asr_and_tts_tpu_torch.tts.synthesizer import Synthesizer
    from toolbox_for_asr_and_tts_tpu_torch.utils.audio import base64_to_audio_np
    _, sv, punc, kws = models
    t_phase = time.perf_counter()
    out = {"card": card}
    server = None
    try:
        cmvn = seeded_cmvn(reco.cfg.input_dim)
        vad_params = fsmn_vad.init_params(             # as _vad_factory's
            fsmn_vad.FsmnVadConfig(), torch.Generator().manual_seed(7))
        t0 = time.perf_counter()
        dirs, written, vp_folded = write_mount(
            torch, root, reco, cmvn, sv, punc, kws, vad_params, synth)
        out["write_s"] = time.perf_counter() - t0
        out["bytes_written"] = written
        print(f"checkpoints: mount of {sum(written.values()) / 1e9:.3f} GB "
              f"written in {out['write_s']:.1f} s under a temporary root "
              f"({', '.join(f'{k} {v / 1e6:.1f} MB' for k, v in written.items())})",
              flush=True)

        loads = {}
        # the recognizer: cold, warm; ids and launches against memory
        loaded, cold, warm = timed_loads(
            torch, lambda: Recognizer.from_model_dir(
                dirs["paraformer_offline"]))
        loads["paraformer_offline"] = dict(cold_s=cold, warm_s=warm)
        require(loaded.device == reco.device and loaded.cfg == reco.cfg
                and not loaded.has_bicif, f"loaded cfg {loaded.cfg}")
        n_leaves = trees_equal(loaded.params, reco.params,
                               "Paraformer-large")
        in_memory = Recognizer(reco.params, reco.cfg, reco.tokenizer,
                               cmvn=cmvn)
        for a, b in zip(loaded.cmvn, in_memory.cmvn):
            require(torch.equal(a, b), "am.mvn read back inexactly")
        got, k1, k2 = counted(torch, lambda: loaded.transcribe(wavs))
        want = in_memory.transcribe(wavs)
        check_results(got, wavs, reco.cfg)
        require([r.token_ids for r in got] == [r.token_ids for r in want],
                "loaded token ids differ from the in-memory recognizer's")
        enc, dec = reco.cfg.encoder_layers, reco.cfg.decoder_layers
        require(k1 == enc + dec and k2 == 1,
                f"loaded transcribe: K1 {k1}, K2 {k2}")
        hw = hotwords_for(loaded, got)
        got_hw, k1_hw, k2_hw = counted(
            torch, lambda: loaded.transcribe(wavs, hotwords=hw))
        want_hw = in_memory.transcribe(wavs, hotwords=hw)
        require([r.token_ids for r in got_hw]
                == [r.token_ids for r in want_hw],
                "loaded token ids with hotwords differ")
        require(k1_hw == enc + 2 * dec and k2_hw == 1,
                f"loaded transcribe with hotwords: K1 {k1_hw}, K2 {k2_hw}")
        out["recognizer"] = dict(
            leaves=n_leaves, rows=len(wavs),
            tokens=sum(len(r.token_ids) for r in got), k1=k1, k2=k2,
            k1_hotwords=k1_hw, k2_hotwords=k2_hw)
        print(f"checkpoints: Recognizer.from_model_dir cold {cold:.2f} s, "
              f"warm {warm:.2f} s; {n_leaves} leaves equal the in-memory "
              f"tree; {len(wavs)} rows, {out['recognizer']['tokens']} token ids equal "
              f"the in-memory recognizer's with the same am.mvn (and with "
              f"hotwords); K1 {k1} / K2 {k2} per transcribe, {k1_hw} / "
              f"{k2_hw} with rescoring", flush=True)
        del loaded
        if profile:
            out["profile_paraformer_load"] = profile_load(
                torch, dirs["paraformer_offline"], reco.cfg)

        # the other voice families: cold, warm, trees equal
        sv_l, cold, warm = timed_loads(
            torch, lambda: SpeakerVerifier.from_model_dir(dirs["sv"]))
        loads["sv"] = dict(cold_s=cold, warm_s=warm)
        trees_equal(sv_l.params, sv.params, "CAM++")
        punc_l, cold, warm = timed_loads(
            torch, lambda: Punctuator.from_model_dir(dirs["punc"]))
        loads["punc"] = dict(cold_s=cold, warm_s=warm)
        require(punc_l.cfg == punc.cfg and
                punc_l.vocab.tokens == punc.vocab.tokens, "punc cfg / vocab")
        trees_equal(punc_l.params, punc.params, "CT-Transformer")
        kws_l, cold, warm = timed_loads(
            torch, lambda: KeywordSpotter.from_model_dir(
                dirs["kws"], threshold=kws.threshold))
        loads["kws"] = dict(cold_s=cold, warm_s=warm)
        require(kws_l.cfg == kws.cfg, "KWS cfg")
        trees_equal(kws_l.params, kws.params, "KWS")
        (vad_l, vad_cfg, vad_cmvn), cold, warm = timed_loads(
            torch, lambda: fsmn_vad.from_model_dir(dirs["fsmn_vad"]))
        loads["fsmn_vad"] = dict(cold_s=cold, warm_s=warm)
        require(vad_cfg == fsmn_vad.FsmnVadConfig() and vad_cmvn is None,
                "FSMN-VAD cfg")
        trees_equal(vad_l, vad_params, "FSMN-VAD")
        del vad_l

        # direct calls: identical outputs, launches as phase 6
        rng = np.random.default_rng(7)
        words = split_words("".join(chr(0x4E00 + int(c))
                                    for c in rng.integers(0, 20000, 40)))
        require((punc_l.classify(words) == punc.classify(words)).all(),
                "loaded punctuation ids differ")
        emb_wavs = [w[: int(s * SR)] for w, s in zip(wavs, (4.0, 2.5, 1.4))]
        ea, eb = sv_l.embed(emb_wavs), sv.embed(emb_wavs)
        require(np.array_equal(ea, eb), "loaded CAM++ embeddings differ")
        windows = [w[:KWS_WINDOW] for w in session_audio(8, seed=700)]
        sa = [s for _, s in kws_l.detect_audio_batch(windows)]
        sb = [s for _, s in kws.detect_audio_batch(windows)]
        require(sa == sb, f"loaded KWS scores {sa} vs {sb}")
        out["direct"] = dict(punctuation_ids_equal=len(words),
                             embeddings_equal=len(emb_wavs),
                             kws_scores_equal=len(windows),
                             **service_launches(torch, sv_l, punc_l, kws_l))
        del sv_l, punc_l, kws_l

        # the voice service from the mount: build_engines behind create_app
        t0 = time.perf_counter()
        engines = E.build_engines(model_dir=root)
        t_built = time.perf_counter() - t0
        server = Server(voice_app(engines))
        b64 = wav_b64(make_wavs()[5][: 8 * SR])
        status, rest = http_json(
            server.app.port, "POST", "/api/v1/voice/asr", json.dumps(
                {"audio_data": b64, "use_wake": False}).encode())
        startup = time.perf_counter() - t0
        require(status == 200 and rest.get("success"),
                f"REST from the mount: {status} {rest}")
        diar = engines.diarizer.inner
        require(diar.recognizer.cfg == reco.cfg
                and engines.streaming_factory.hub.ticker.cmvn is not None,
                "the served recognizers")
        wav = base64_to_audio_np(b64)
        mem = Diarizer(in_memory, sv, punctuator=punc).diarize(wav)
        served = diar.diarize(wav)
        direct = apply_hard_corrections("".join(s.text for s in mem))
        require(rest["text"] == direct,
                f"REST text {rest['text']!r} vs in-memory {direct!r}")
        spk = [(s.text, s.spk, s.start_ms, s.end_ms) for s in served]
        require(spk == [(s.text, s.spk, s.start_ms, s.end_ms)
                        for s in mem], "speaker results differ")
        out["service"] = dict(build_engines_s=t_built,
                              startup_to_first_answer_s=startup,
                              chars=len(rest["text"]), sentences=len(mem),
                              speakers=sorted({s.spk for s in mem}))
        print(f"checkpoints: build_engines(model_dir=root) in {t_built:.1f} s "
              f"(warm caches, the online partials on the symlinked dir); "
              f"first REST answer {startup:.1f} s after the start, text of "
              f"{len(rest['text'])} chars and {len(mem)} sentences with "
              f"speakers {out['service']['speakers']} equal to the "
              f"in-memory diarize on {card}", flush=True)

        # TTS from the mount, PNCA, against the weights the package defines
        segments = tts_segments(synth)
        tts_l, cold, warm = timed_loads(
            torch, lambda: Synthesizer.from_model_dir(dirs["tts"]))
        loads["tts"] = dict(cold_s=cold, warm_s=warm)
        require(tts_l.decoder_mode == "pnca", "a loaded package decodes PNCA")
        require(tts_l.acfg == synth.acfg and tts_l.vcfg == synth.vcfg,
                f"loaded TTS cfgs {tts_l.acfg} {tts_l.vcfg}")
        tts_pin(tts_l, "pnca")
        mem_tts = tts_pin(Synthesizer(synth.ap, synth.acfg, vp_folded,
                                      synth.vcfg), "pnca")
        (wa, da), n = tts_counted(torch, tts_l, lambda: tts_l.synthesize_segments(
            segments[:1], MOUNT_VOICE))
        wb, db = mem_tts.synthesize_segments(segments[:1], MOUNT_VOICE)
        require(n["k1"] == 0 and n["k2"] == 0 and n["ar_steps"] > 0,
                f"loaded PNCA programs {n}")
        require(da == db and np.array_equal(pcm16(wa[0]), pcm16(wb[0])),
                "loaded PNCA PCM differs from the in-memory synthesizer's")
        tts_pin(synth, "pnca")
        try:
            wc, _ = synth.synthesize_segments(segments[:1], MOUNT_VOICE)
        finally:
            tts_pin(synth, "nar")
        lsb = int(np.abs(pcm16(wa[0]) - pcm16(wc[0])).max())
        require(len(wa[0]) == len(wc[0]) and lsb <= TTS_PCM_LSB,
                f"against phase 7's unfolded vocoder: {lsb} LSB")
        del tts_l, mem_tts
        out["tts"] = dict(samples=len(wa[0]), ar_steps=n["ar_steps"],
                          max_lsb_vs_unfolded_vocoder=lsb)
        print(f"checkpoints: Synthesizer.from_model_dir (BatchNorm postnet "
              f"and weight-norm vocoder folded) PNCA on segment 0: "
              f"{len(wa[0])} samples equal the in-memory synthesizer's "
              f"sample for sample, {n['ar_steps']} AR steps; {lsb} LSB from "
              f"phase 7's vocoder before the weight-norm round trip",
              flush=True)

        # the TTS app from the mount: create_app → first answer
        from toolbox_for_asr_and_tts_tpu_torch.runtime.config import TTSConfig
        from toolbox_for_asr_and_tts_tpu_torch.service.tts_app import create_app
        t0 = time.perf_counter()
        tserver = Server(create_app(cfg=TTSConfig(model_dir=root)))
        try:
            status, job = http_json(tserver.app.port, "POST",
                                    "/api/v1/tts/start", json.dumps(
                                        {"text": segments[0]}).encode())
            require(status == 200, f"TTS start: {status} {job}")
            for _ in range(1200):
                status, body = http_json(
                    tserver.app.port, "GET",
                    f"/api/v1/tts/result/{job['job_id']}")
                if body["status"] in ("completed", "error"):
                    break
                time.sleep(0.02)
            require(body["status"] == "completed", f"TTS job: {body}")
            tts_startup = time.perf_counter() - t0
        finally:
            tserver.stop()
        out["tts"]["app_startup_to_completed_s"] = tts_startup

        out["loads"] = loads
        out["cache_bytes"] = cache_bytes(root)
        print(f"checkpoints: TTS app create_app(model_dir=root) to a "
              f"completed job {tts_startup:.1f} s; caches "
              f"{out['cache_bytes'] / 1e9:.3f} GB; loads (cold / warm s): "
              + ", ".join(f"{k} {v['cold_s']:.2f} / {v['warm_s']:.2f}"
                          for k, v in loads.items()) + f" on {card}",
              flush=True)
    except BaseException:
        if server is not None:
            server.stop()
        raise
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"checkpoints phase: {out['phase_s']:.1f} s", flush=True)
    return out, (server, engines)


# ------------------------------------------------ phase 9: the entry points
FUNASR_FRAME = 960            # samples per FunASR binary frame (60 ms)
ENTRY_SECONDS = 8             # of phase 6's REST audio per request
FUNASR_MODES = ("offline", "online", "2pass")
WSLOAD_STREAMS, WSLOAD_CYCLES = 16, 2
SIGTERM_LIMIT_S = 15.0
CHILD_TIMEOUT_S = 300


def entry_audio():
    """Phase 6's REST audio, 8 s, as int16 PCM and as the float samples
    that both the FunASR server (PCM / 32768) and the WAV decoder give."""
    import numpy as np
    x = make_wavs()[5][: ENTRY_SECONDS * SR]
    pcm16 = np.clip(np.round(x * 32768.0), -32768, 32767).astype("<i2")
    return pcm16, pcm16.astype(np.float32) / 32768.0


def pcm_wav_bytes(pcm16) -> bytes:
    """A 16 kHz mono 16-bit WAV holding exactly these samples."""
    import struct
    data = pcm16.tobytes()
    return (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, 1, SR, 2 * SR, 2, 16)
            + b"data" + struct.pack("<I", len(data)) + data)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def funasr_request(port: int, mode: str, pcm16, paced: bool):
    """One FunASR utterance on its own connection: the init frame, the PCM
    in 60 ms binary frames (in real time when `paced`), then
    {"is_speaking": false}. Returns (the replies [(t, msg)], the time the
    end marker was sent); the server closing the connection (1011 on a
    model error) fails the phase."""
    ws = RawWS(port, path="/")
    try:
        ws.send(0x1, json.dumps({
            "mode": mode, "wav_name": f"smoke-{mode}", "is_speaking": True,
            "chunk_size": [5, 10, 5], "wav_format": "pcm",
            "audio_fs": SR}).encode())
        raw = pcm16.tobytes()
        t0 = time.perf_counter()
        for i, j in enumerate(range(0, len(raw), 2 * FUNASR_FRAME)):
            delay = t0 + i * FUNASR_FRAME / SR - time.perf_counter()
            if paced and delay > 0:
                time.sleep(delay)
            ws.send(0x2, raw[j:j + 2 * FUNASR_FRAME])
        t_end = ws.send(0x1, b'{"is_speaking": false}')
        ws.wait_for(lambda m: any(x.get("is_final") for _, x in m), 300)
    finally:
        ws.close()
    return list(ws.messages), t_end


def settled(ws_server, timeout: float = 30.0) -> None:
    """Wait until the FunASR server holds no streaming session: every
    finished utterance's finalize and close have returned."""
    end = time.perf_counter() + timeout
    while ws_server.sessions() and time.perf_counter() < end:
        time.sleep(0.01)


def start_child(argv, env_extra, cwd: str, name: str):
    """A child process of this interpreter with the repository on its
    path; its output goes to files under cwd. A thread notes when it
    exits (`t_end`)."""
    import threading
    env = dict(os.environ, PYTHONPATH=ROOT, **env_extra)
    out = open(os.path.join(cwd, f"{name}.out"), "w")
    err = open(os.path.join(cwd, f"{name}.err"), "w")
    proc = subprocess.Popen([sys.executable, *argv], cwd=cwd, env=env,
                            stdout=out, stderr=err, text=True)
    proc.files = (out, err)
    proc.name = name
    proc.t_start = time.perf_counter()
    proc.t_end = None

    def watch():
        proc.wait()
        proc.t_end = time.perf_counter()
    threading.Thread(target=watch, daemon=True).start()
    return proc


def watch_health(proc, port: int) -> None:
    """Note (`t_ready`) when the child's app first answers GET /health."""
    import threading
    proc.t_ready = None

    def poll():
        while proc.poll() is None:
            try:
                if http_json(port, "GET", "/health")[0] == 200:
                    proc.t_ready = time.perf_counter()
                    return
            except OSError:
                pass
            time.sleep(0.1)
    threading.Thread(target=poll, daemon=True).start()


def child_output(proc):
    for f in proc.files:
        f.close()
    with open(proc.files[0].name) as f:
        out = f.read()
    with open(proc.files[1].name) as f:
        err = f.read()
    return out, err


def wait_child(proc, timeout: float = CHILD_TIMEOUT_S):
    """Wait for a child; require exit 0. Returns (stdout, stderr)."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    while proc.t_end is None:   # the watcher thread notes the exit
        time.sleep(0.01)
    out, err = child_output(proc)
    require(proc.returncode == 0,
            f"{proc.name} exited {proc.returncode}: {err[-3000:]}")
    return out, err


def stop_children(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        for f in p.files:
            f.close()


def funasr_phase(torch, server, engines, models, pcm16, audio):
    """(a): the port's FunASR server in-process over the mounted engines:
    offline (sent at once), online and 2pass (in real time); launches
    accounted around each request; the final texts against the REST
    answer and a direct diarize + ITN on the same samples; ChunkedHub rows
    and streaming sessions after the connections close."""
    import base64
    from toolbox_for_asr_and_tts_tpu_torch.asr.corrections import (
        apply_hard_corrections)
    from toolbox_for_asr_and_tts_tpu_torch.asr.itn import apply_itn
    from toolbox_for_asr_and_tts_tpu_torch.native.bridge import (
        start_offline_asr_server)
    t0 = time.perf_counter()
    ws_server = start_offline_asr_server(engines, port=0)
    started = time.perf_counter() - t0
    out = {"native_server_start_s": started}
    try:
        def request(mode):
            got = funasr_request(ws_server.port, mode, pcm16,
                                 paced=mode != "offline")
            settled(ws_server)   # 2pass flushes its session after the final
            return got

        for mode in FUNASR_MODES:
            (replies, t_end), launches = accounted(
                torch, f"FunASR {mode}", engines, models,
                lambda: request(mode))
            final = [(t, m) for t, m in replies if m.get("is_final")]
            partials = [m for _, m in replies if not m.get("is_final")]
            require(len(final) == 1, f"FunASR {mode}: finals {final}")
            t_final, msg = final[0]
            want_mode = "2pass-offline" if mode == "2pass" else mode
            require(msg["mode"] == want_mode
                    and msg["wav_name"] == f"smoke-{mode}",
                    f"FunASR {mode}: final {msg}")
            if mode != "offline":
                require(partials and all(
                    m["mode"] == ("2pass-online" if mode == "2pass"
                                  else "online") and m["text"]
                    for m in partials), f"FunASR {mode}: partials {partials}")
            out[mode] = dict(final_after_end_ms=(t_final - t_end) * 1e3,
                             text=msg["text"], partials=len(partials),
                             launches=launches)
            print(f"entry points: FunASR {mode}: final {len(msg['text'])} "
                  f"chars {(t_final - t_end) * 1e3:.1f} ms after "
                  f"is_speaking false, {len(partials)} partials", flush=True)
        # the same samples through REST and through a direct diarize
        b64 = base64.b64encode(pcm_wav_bytes(pcm16)).decode()
        status, rest = http_json(server.app.port, "POST",
                                 "/api/v1/voice/asr", json.dumps(
                                     {"audio_data": b64,
                                      "use_wake": False}).encode())
        require(status == 200 and rest.get("success"), f"REST {rest}")
        raw = "".join(s.text for s in engines.diarizer.inner.diarize(audio))
        require(raw, "the direct diarize gave no text")
        for mode in ("offline", "2pass"):
            require(out[mode]["text"] == apply_itn(raw),
                    f"FunASR {mode} text {out[mode]['text']!r} vs diarize + "
                    f"ITN {apply_itn(raw)!r}")
        require(rest["text"] == apply_hard_corrections(raw),
                f"REST text {rest['text']!r} vs diarize + corrections")
        out["rest_text"] = rest["text"]
        out["texts_equal_rest"] = out["offline"]["text"] == rest["text"]
        # rows: every connection is closed; the hub must hold none
        ticker = engines.streaming_factory.hub.ticker
        settled(ws_server)
        out["chunked_rows_in_use"] = ticker.n_live
        out["streaming_sessions_open"] = ws_server.sessions()
        require(ticker.n_live == 0 and ws_server.sessions() == 0,
                f"{ticker.n_live} ChunkedHub rows, {ws_server.sessions()} "
                f"sessions in use after the connections closed")
    finally:
        ws_server.stop()
    print(f"entry points: FunASR offline and 2pass texts = diarize + ITN "
          f"({len(out['offline']['text'])} chars; equal to the REST text, "
          f"which takes the hard corrections instead: "
          f"{out['texts_equal_rest']}); ChunkedHub rows in use after close "
          f"{out['chunked_rows_in_use']}; native server started in "
          f"{started * 1e3:.1f} ms", flush=True)
    return out


def launch_child_phase(proc, vport: int, wport: int, pcm16, funasr):
    """(b): launch_voice() in a child, started as the deploy image starts
    it: wait for /health, one REST /asr and one FunASR offline request
    (the texts of (a)), then SIGTERM: exit 0 within the limit. The
    start-up time runs from the child's start to its first /health
    answer (`watch_health`)."""
    import base64
    import signal
    end = time.perf_counter() + CHILD_TIMEOUT_S
    while proc.t_ready is None:
        require(proc.poll() is None, "launch_voice exited early: "
                + child_output(proc)[1][-3000:])
        require(time.perf_counter() < end, "launch_voice never answered")
        time.sleep(0.1)
    first_answer = proc.t_ready - proc.t_start
    b64 = base64.b64encode(pcm_wav_bytes(pcm16)).decode()
    status, rest = http_json(vport, "POST", "/api/v1/voice/asr", json.dumps(
        {"audio_data": b64, "use_wake": False}).encode())
    replies, _ = funasr_request(wport, "offline", pcm16, paced=False)
    text = next(m for _, m in replies if m.get("is_final"))["text"]
    require(status == 200 and rest["text"] == funasr["rest_text"],
            f"launch_voice REST {rest} vs {funasr['rest_text']!r}")
    require(text == funasr["offline"]["text"],
            f"launch_voice FunASR {text!r} vs {funasr['offline']['text']!r}")
    t0 = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=SIGTERM_LIMIT_S)
    except subprocess.TimeoutExpired:
        raise PhaseError(f"launch_voice still running {SIGTERM_LIMIT_S} s "
                         f"after SIGTERM")
    stopped = time.perf_counter() - t0
    _, err = child_output(proc)
    require(proc.returncode == 0,
            f"launch_voice exited {proc.returncode}: {err[-3000:]}")
    built = re.search(r"engines built in ([0-9.]+) s", err)
    require(built is not None, "launch_voice logged no build_engines time: "
            + err[-3000:])
    build_s = float(built.group(1))
    print(f"entry points: launch_voice first answered {first_answer:.1f} s "
          f"after its start, {build_s:.2f} s of it build_engines from the "
          f"mount (the child's own log); its REST and FunASR texts equal "
          f"(a)'s; SIGTERM → exit 0 in {stopped:.2f} s", flush=True)
    return dict(startup_to_first_answer_s=first_answer, build_engines_s=build_s,
                sigterm_exit_s=stopped, exit_code=proc.returncode)


def cli_phase(procs, root: str, work: str, wav_path: str, tts_text: str,
              funasr, tts_samples: int):
    """(c): the CLI children, one after the other: `transcribe --itn`
    prints (a)'s offline text; `tts -o` from the mounted package writes a
    WAV at least as long as phase 8's PNCA segment."""
    from toolbox_for_asr_and_tts_tpu_torch.utils.audio import read_wav
    tts_out = os.path.join(work, "tts.wav")
    transcribe = start_child(
        ["-m", "toolbox_for_asr_and_tts_tpu_torch.cli", "transcribe",
         wav_path, "--itn", "--model-dir", root], {}, work, "cli_transcribe")
    procs.append(transcribe)
    out, _ = wait_child(transcribe)
    rows = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    require(len(rows) == 1 and rows[0]["file"] == wav_path,
            f"cli transcribe printed {out[-2000:]}")
    require(rows[0]["text"] == funasr["offline"]["text"],
            f"cli transcribe {rows[0]['text']!r} vs "
            f"{funasr['offline']['text']!r}")
    t_transcribe = transcribe.t_end - transcribe.t_start
    tts = start_child(
        ["-m", "toolbox_for_asr_and_tts_tpu_torch.cli", "tts", tts_text,
         "--model-dir", root, "-o", tts_out], {}, work, "cli_tts")
    procs.append(tts)
    out, _ = wait_child(tts)
    rep = json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])
    wav, sr = read_wav(tts_out)
    require(sr == SR and len(wav) >= tts_samples and rep["output"] == tts_out,
            f"cli tts wrote {len(wav)} samples at {sr} Hz (phase 8's PNCA "
            f"segment: {tts_samples})")
    t_tts = tts.t_end - tts.t_start
    print(f"entry points: cli transcribe --itn printed (a)'s text (the "
          f"process took {t_transcribe:.1f} s, the engines' load included); "
          f"cli tts from the mount wrote {len(wav)} samples ({t_tts:.1f} s)",
          flush=True)
    return dict(transcribe_s=t_transcribe, tts_s=t_tts,
                tts_samples=len(wav))


def wsload_phase(torch, server, engines, models, work: str):
    """(d): the port's epoll load generator against the mounted voice app: S
    = 16 streams, 2 cycles (the first a grace cycle), real-time 0.4 s
    chunks of 3 speech + 7 silence, no chunk_end frames; launches
    accounted over the run."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.native.bridge import (
        WSLOAD, build_library)
    binary = build_library(WSLOAD)
    speech = session_audio(1, seed=900)[0][:CHUNK]
    with open(os.path.join(work, "speech.pcm"), "wb") as f:
        f.write(pcm(speech))
    with open(os.path.join(work, "silence.pcm"), "wb") as f:
        f.write(np.zeros(CHUNK, "<i2").tobytes())
    cmd = [binary, "--port", str(server.app.port), "--n",
           str(WSLOAD_STREAMS), "--cycles", str(WSLOAD_CYCLES),
           "--deadline", "10", "--hard-timeout", "60",
           "--speech", os.path.join(work, "speech.pcm"),
           "--silence", os.path.join(work, "silence.pcm")]
    t0 = time.perf_counter()
    proc, launches = accounted(
        torch, f"wsload S={WSLOAD_STREAMS}", engines, models,
        lambda: subprocess.run(cmd, capture_output=True, text=True,
                               timeout=240))
    wall = time.perf_counter() - t0
    require(proc.returncode == 0, f"wsload_client: {proc.stderr[-2000:]}")
    recs = [json.loads(x) for x in proc.stdout.splitlines() if x.strip()]
    streams = [r for r in recs if "idx" in r]
    summary = next(r["summary"] for r in recs if "summary" in r)
    lat = [v for r in streams for v in r["lat"]]
    require(summary.get("ok") == WSLOAD_STREAMS == len(streams)
            and all(r["ok"] for r in streams) and lat,
            f"wsload_client: {proc.stdout[-2000:]}")
    row = dict(streams=len(streams), ok=summary["ok"],
               ok_per_stream=[r["ok"] for r in streams],
               result_latency=quantiles(lat), wall_s=wall,
               launches=launches)
    print(f"entry points: wsload_client {summary['ok']}/{len(streams)} "
          f"streams ok; result latency median "
          f"{row['result_latency']['median_ms']:.1f} ms, p95 "
          f"{row['result_latency']['p95_ms']:.1f} ms ({len(lat)} results) "
          f"in {wall:.1f} s", flush=True)
    return row


def entry_points_path(torch, card, root, mounted, tts_text: str,
                      tts_samples: int):
    """Phase 9: the deployed entry points at full width on the card, over
    phase 8's mount. Each part runs with nothing else loading or serving
    on the host or the card: (a) and (d) in this process, then the
    children (launch_voice, the CLI's transcribe, its tts) one at a time,
    so that each time is the layer's own."""
    t_phase = time.perf_counter()
    server, engines = mounted
    diar = engines.diarizer.inner
    models = (diar.recognizer, diar.verifier, diar.punctuator,
              engines.kws.inner)
    pcm16, audio = entry_audio()
    work = os.path.join(root, "entry-points")
    os.makedirs(work)
    wav_path = os.path.join(work, "utterance.wav")
    with open(wav_path, "wb") as f:
        f.write(pcm_wav_bytes(pcm16))
    procs = []
    try:
        out = {"card": card}
        out["funasr"] = funasr_phase(torch, server, engines, models, pcm16,
                                     audio)
        out["wsload"] = wsload_phase(torch, server, engines, models, work)
        vport, wport = free_port(), free_port()
        procs.append(start_child(
            ["-c", "from toolbox_for_asr_and_tts_tpu_torch.launch import "
             "launch_voice; launch_voice()"],
            dict(VOICE_MODEL_DIR=root, VOICE_HOST="127.0.0.1",
                 VOICE_PORT=str(vport), FUNASR_WS_PORT=str(wport)),
            work, "launch_voice"))
        watch_health(procs[0], vport)
        out["launch_voice"] = launch_child_phase(procs[0], vport, wport,
                                                 pcm16, out["funasr"])
        out["cli"] = cli_phase(procs, root, work, wav_path, tts_text,
                               out["funasr"], tts_samples)
    finally:
        stop_children(procs)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"entry points phase: {out['phase_s']:.1f} s on {card}", flush=True)
    return out


# ---------------------------------------------------------------- main
def main(argv) -> int:
    import shutil
    import tempfile
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from toolbox_for_asr_and_tts_tpu_torch.ops.kernels import _build
    except ImportError:
        print("chip_smoke: the port's package is not beside this script",
              file=sys.stderr)
        return 1
    profile = "--profile" in argv
    try:
        card = card_line()
        print(card, flush=True)       # name, power limit: as nvidia-smi says
        kind = torch.cuda.get_device_name(0)
        peaks = card_peaks(kind)
        print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"cuda {torch.version.cuda}; peaks used for bounds: "
              f"{peaks[0] / 1e12} TB/s, {peaks[1] / 1e12} TFLOP/s f32",
              flush=True)
        _build.load()
        info = _build.build_info
        print(f"kernels built from {', '.join(_build.SOURCES)} in "
              f"{info['seconds']:.1f} s (cached {info['cached']}) -> "
              f"{os.path.relpath(info['path'], ROOT)}", flush=True)
        for line in str(info["log"]).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas: {line.strip()}")
        from toolbox_for_asr_and_tts_tpu_torch.native import bridge
        t0 = time.perf_counter()
        bridge.build_library()
        print(f"native libraries (g++, {', '.join(bridge.TARGETS)}) ready in "
              f"{time.perf_counter() - t0:.1f} s -> "
              f"{os.path.relpath(bridge.build_dir(), ROOT)}", flush=True)

        # off for every phase: the comparisons need full f32, and the main
        # path then runs as it is compared (the package sets neither flag)
        print(set_tf32(torch, False), flush=True)
        floor_ms = device_ms(torch, lambda: torch.cuda._sleep(1))
        print(f"launch floor of the event method (a 1-cycle spin kernel): "
              f"{floor_ms * 1e3:.2f} us per launch", flush=True)
        k1_rows = check_k1(torch, peaks, floor_ms)
        if "--sweep" in argv:
            sweep_k1(torch)
        k2_row = check_k2(torch, peaks)
        k1_stream, k2_stream = check_streaming_kernels(torch, peaks, floor_ms)
        k1_service, k2_service = check_service_kernels(torch, peaks, floor_ms)
        reco, wavs, launches, rtf = main_path(torch, card, profile)
        compare_cpu(torch, reco, wavs)
        streaming, compare_ids, compare_audio = streaming_path(
            torch, card, reco.params, profile)
        streaming["card_vs_cpu"] = compare_streaming(
            torch, reco.params, compare_ids, compare_audio)
        service, models = service_path(torch, card, reco, profile)
        tts, synth = tts_path(torch, card, profile)
        root = tempfile.mkdtemp(prefix="mounted-damo-")
        mounted = None
        try:
            checkpoints, mounted = checkpoints_path(
                torch, card, root, reco, wavs, models, synth, profile)
            entry_points = entry_points_path(
                torch, card, root, mounted, tts_segments(synth)[0],
                checkpoints["tts"]["samples"])
        finally:
            if mounted is not None:
                mounted[0].stop()
            shutil.rmtree(root, ignore_errors=True)
    except Exception:   # every phase failure ends the run without a result
        traceback.print_exc()
        return 1

    main_k1 = next(r for r in k1_rows
                   if r["site"] == "encoder" and r["dtype"] == "float32")
    served = {run: service[run]["launches"]
              for run in [f"S{n}" for n in SERVICE_SIZES] + ["four_modes",
                                                             "rest"]}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "call_ms")

    def entry_launches(k):
        runs = {f"funasr_{m}": entry_points["funasr"][m]["launches"]
                for m in FUNASR_MODES}
        runs["wsload"] = entry_points["wsload"]["launches"]
        return {r: c[k] for r, c in runs.items()}
    kernels = [
        dict(name="fsmn_conv", route="cuda",
             source="toolbox_for_asr_and_tts_tpu_torch/csrc/fsmn_conv.cu",
             replaces="toolbox_for_asr_and_tts_tpu/ops/pallas/fsmn_conv.py:38",
             launches=launches["K1"],
             **{k: main_k1[k] for k in keys},
             strided_ms=main_k1["strided_ms"],
             launch_floor_ms=main_k1["launch_floor_ms"],
             tile=main_k1["tile"],
             launches_with_rescoring=launches["K1_rescoring"],
             launches_per_chunked_step=streaming["S64"]["k1_per_step"],
             launches_per_vad_tick=streaming["vad"]["k1_per_tick"],
             launches_per_punctuate_forward=service["launches"][
                 "k1_per_punctuate_forward"],
             launches_per_kws_batch=service["launches"]["k1_per_kws_batch"],
             launches_per_embed=service["launches"]["k1_per_embed"],
             launches_service={r: c["k1"] for r, c in served.items()},
             launches_tts=tts["launches"]["k1"],
             launches_loaded=checkpoints["recognizer"]["k1"],
             launches_loaded_with_rescoring=checkpoints["recognizer"][
                 "k1_hotwords"],
             launches_entry_points=entry_launches("k1"),
             shapes=k1_rows + k1_stream + k1_service),
        dict(name="frame_window", route="cuda",
             source="toolbox_for_asr_and_tts_tpu_torch/csrc/frame_window.cu",
             replaces="toolbox_for_asr_and_tts_tpu/ops/pallas/frame_window.py:56",
             launches=launches["K2"],
             **{k: k2_row[k] for k in keys},
             shape=k2_row["shape"],
             launches_per_chunked_step=streaming["S64"]["k2_per_step"],
             launches_per_vad_tick=streaming["vad"]["k2_per_tick"],
             launches_per_punctuate_forward=service["launches"][
                 "k2_per_punctuate_forward"],
             launches_per_kws_batch=service["launches"]["k2_per_kws_batch"],
             launches_per_embed=service["launches"]["k2_per_embed"],
             launches_service={r: c["k2"] for r, c in served.items()},
             launches_tts=tts["launches"]["k2"],
             launches_loaded=checkpoints["recognizer"]["k2"],
             launches_entry_points=entry_launches("k2"),
             shapes=[k2_row] + k2_stream + k2_service),
    ]
    print(json.dumps({"rtf_batch8": rtf, "card": card}))
    print(json.dumps({"streaming": streaming, "card": card}))
    print(json.dumps({"service": service, "card": card}))
    print(json.dumps({"tts": tts, "card": card}))
    print(json.dumps({"checkpoints": checkpoints}))
    print(json.dumps({"entry_points": entry_points}, ensure_ascii=False))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
