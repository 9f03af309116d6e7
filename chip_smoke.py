#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py             # from the repository root
    python3 chip_smoke.py --profile   # also: torch.profiler breakdown of one
                                      # transcribe by CUDA kernel, and the
                                      # card's busy time per streaming step
    python3 chip_smoke.py --sweep     # also: K1's device time per tile

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit (nvidia-smi); build the CUDA kernels
   from `toolbox_for_asr_and_tts_tpu_torch/csrc/` (nvcc, sm_90a);
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
5. the `streaming` and `kernels` JSON lines, then the result line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Needs one card, no network, and only the files of this repository.
"""
from __future__ import annotations

import json
import os
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
    """The library yardstick of a length-preserving K1 call with a
    symmetric pad: one `F.conv1d(groups=D)` and the residual add."""
    import torch.nn.functional as F

    def library(x, w):
        y = F.conv1d(x.transpose(1, 2), w, padding=pad[0], groups=x.shape[-1])
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


# ---------------------------------------------------------------- main
def main(argv) -> int:
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
        reco, wavs, launches, rtf = main_path(torch, card, profile)
        compare_cpu(torch, reco, wavs)
        streaming, compare_ids, compare_audio = streaming_path(
            torch, card, reco.params, profile)
        streaming["card_vs_cpu"] = compare_streaming(
            torch, reco.params, compare_ids, compare_audio)
    except Exception:   # every phase failure ends the run without a result
        traceback.print_exc()
        return 1

    main_k1 = next(r for r in k1_rows
                   if r["site"] == "encoder" and r["dtype"] == "float32")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "call_ms")
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
             shapes=k1_rows + k1_stream),
        dict(name="frame_window", route="cuda",
             source="toolbox_for_asr_and_tts_tpu_torch/csrc/frame_window.cu",
             replaces="toolbox_for_asr_and_tts_tpu/ops/pallas/frame_window.py:56",
             launches=launches["K2"],
             **{k: k2_row[k] for k in keys},
             shape=k2_row["shape"],
             launches_per_chunked_step=streaming["S64"]["k2_per_step"],
             launches_per_vad_tick=streaming["vad"]["k2_per_tick"],
             shapes=[k2_row] + k2_stream),
    ]
    print(json.dumps({"rtf_batch8": rtf, "card": card}))
    print(json.dumps({"streaming": streaming, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
