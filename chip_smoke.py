#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py             # from the repository root
    python3 chip_smoke.py --profile   # also: torch.profiler breakdown of one
                                      # transcribe by CUDA kernel, the
                                      # card's busy time per streaming step,
                                      # over an S = 16 service run and over
                                      # one TTS synthesize, and the stages
                                      # of a Paraformer-large load
    python3 chip_smoke.py --sweep     # also: K1's device time per tile,
                                      # and K1's backward kernel's per tile
                                      # (channels x frames per block) at
                                      # B 8 and 64
    python3 chip_smoke.py --only-mesh # phases 1 and 13 alone (no result
                                      # line)
    python3 chip_smoke.py --only-paths
                                      # phase 1, K2 at the unfused quantum
                                      # and phase 14 alone (no result line)
    python3 chip_smoke.py --only-train
                                      # phases 1 and 10 alone (no result
                                      # line)
    python3 chip_smoke.py --only-train-eager
                                      # phase 1 and phase 10's eager steps
                                      # alone (copied beside an older tree,
                                      # times that tree's eager step)

Every model call of the port runs as a program (`runtime/graphs.py`): on
the card one captured CUDA graph per shape bucket, replayed; K1 and K2 run
inside the graphs, and each replay adds the launches its capture recorded
to the kernels' counters, so every launch check below counts replays.

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
   (bytes or flops over its peak rate). K1's backward at the fine-tuning
   shapes (the encoder's V view of [8, 167, 1536], the decoder's
   [8, 32, 512]): through `FsmnDepthwiseFn` one backward is one launch of
   K1's backward kernel (`fsmn_conv_dw`: dx and dw) and no K1 launch; f32
   dx equal bit for bit to the plain version with the taps reversed and
   the pads swapped and within 1e-6 of max|dx| of autograd of the plain
   version, dw against `fsmn_conv_dw_plain` (f32 within 1e-5 of max|dw|),
   bf16 within 1e-2; both bit-equal across two runs and between the eager
   call and two replays of a captured one; the fused and the dw-only
   call's times and the fused call's graph replay beside the plain
   version's, the library's `convolution_backward` (both gradients) and
   the earlier route's form, timed in the same run (the flip and K1 as
   dx, then the dw-only call). TF32 stays off for every phase;
3. the full-width main path: `Recognizer.random(ParaformerConfig(), seed=0)`
   (Paraformer-large: 50 + 16 layers, d 512, vocab 8404) transcribes a
   batch of 8 x up to 10 s of 16 kHz audio, with and without hotwords; the
   kernels' launch counters are zeroed just before each transcribe and read
   just after; RTF of the batch; the forward and rescoring programs'
   replays bit-equal to their eager calls (TF32 off); with `--profile`, K1
   and K2 per launch inside the replay; then the card's forward pass is
   held against the same port on the CPU for 2 of the rows;
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
   1e-3, VAD decisions equal, posteriors within 1e-4); the chunked step
   at 1 and 64 rows and the VAD step at 64 rows replay bit-equal to their
   eager calls, state updates included;
5. the voice service at full width (phase 6): the engines wired as
   `service/engines.py::build_engines` wires them (FinalizeHub over the
   Diarizer with Paraformer-large, CAM++ and the large CT-Transformer;
   KwsHub; VadHub and ChunkedHub with 64 rows; random weights from fixed
   seeds), served by the port's `create_app` on 127.0.0.1 and driven by a
   minimal RFC 6455 client (`RawWS`): S = 1 and 16 concurrent sessions of
   real-time 0.4 s PCM chunks (partial and finalize latency, median and
   p95; S = 16 three times: pipelined, the CHUNKED_PIPELINE=1 default, with
   the FinalizeHub's first captures, then unpipelined, then pipelined
   again), one session through all four modes (wake → enrollment →
   start_asr → an utterance with SV), and the REST endpoint against a
   direct `Diarizer.diarize`. Around each of these runs the launch
   counters are zeroed just before and read just after, and each kernel's
   launches must equal what the run's device programs launch, as the
   models and tickers count them (chunked steps, transcribes, punctuate
   forwards, embeds, KWS forwards, VAD steps); then the launches per
   punctuate forward, KWS batch and embed around direct calls, and
   CT-Transformer, CAM++ (random BatchNorm statistics) and KWS on the card
   against the CPU; the punctuation, embed and KWS programs' replays
   bit-equal to their eager calls; K1 and K2 at the service shapes join
   phase 2. Each
   audio frame the client sends is followed by a `{"type": "chunk_end"}`
   text frame, answered MISSING_AUDIO_DATA, so that replies can be
   attributed to chunks: extra traffic that real clients do not send;
6. the TTS service at full width (phase 7): `Synthesizer.random(seed=0,
   tiny=False)` on the card (Sambert d 256, 4 + 4 layers, 6 PNCA layers;
   HiFi-GAN 512 channels, upsample (5, 5, 4, 2)), pinned to the NAR
   decoder, two-phase, one call per batch of 8 (whatever the dispatch
   profile's groupings, which phase 12 times): a fixed
   14-segment paragraph through `synthesize` (one warm-up, then the median
   of 3: wall, audio seconds, RTF, the probes and synth groups run, no K1
   or K2 launch), `synthesize_stream` (time to the first chunk; its
   concatenation against the one-shot waveform within 1 LSB, equal
   lengths), one segment in PNCA mode (AR steps, and the cost of one step
   from `forward_ar` at two mel lengths, eagerly and as a graph replay; the
   PNCA synthesis program's replay bit-equal to its eager call), card
   against CPU on 2 segments
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
9. fine-tuning at full width (phase 10): `Recognizer.random(
   ParaformerConfig(), seed=0)`'s tree trained by `parallel/trainstep.py`
   (AdamW, lr 1e-4) on phase 3's 8 rows as 16-bit WAVs in a manifest with
   random target ids from a fixed seed (k_max 32; features by
   `tools/finetune._features`, no CMVN): one step's gradients on the card
   against the same port on the CPU for 2 rows cut to 3 s (every leaf
   within 1e-3 of its norm); 8 steps on the fixed batch with the counters
   zeroed just before each and read just after (K1 66, `fsmn_conv_dw` 66,
   K2 1 per step; a finite loss, lower at the end than at the start); a
   fresh seed-0 tree restored from the save at step 4 and continued to 8,
   equal to the uninterrupted run; the eager step's busy time (profiler);
   the card's AdamW made capturable (`train_graph.capturable`) and as it
   is against optax's adamw in float64 over 3 steps (within 1e-2 lr); the
   captured step (`runtime/train_graph.py::capture_train_step`, the
   reference's `jax.jit(train_step)`) on a fresh seed-0 tree over the same
   8 steps: the first the eager step, the second the eager step and the
   capture, then 6 replays each adding K1 66 / dw 66 (K2 1 per step from
   the features), losses, parameters and AdamW state bit-equal to 8 eager
   steps of the same capturable AdamW; a fresh tree whose step has
   captured, restored from the captured run's step-4 save (its program
   dropped and made again) and continued to 8, bit-equal; captured and
   eager step walls (median, p95), capture seconds, the pool's bytes, the
   card's busy time and idle share of one captured and one eager step of
   each AdamW with K1's and K1's backward's time per launch inside each
   (profiler); a `remat=True` pair, 3 eager steps against 3 captured,
   bit-equal with the replay's tally equal to the eager launches; a step
   that syncs inside its capture raising on every capture, saying the
   step was applied, with no graph kept; `tools/finetune.py` with
   `--export` over 4 steps whose T comes back (eager first steps, a
   capture, a replay, as its draws predict), whose export loaded by
   `Recognizer.from_model_dir` transcribes the 8 rows with the ids of a
   Recognizer on the CLI's tuned tree in memory; the share of the CLI's
   steps at a new T on a 1000-row manifest of durations uniform over 1-20
   s (host only), with the steps' time projected from this phase's unit
   costs. cuDNN runs
   deterministic in this phase;
10. reduced precision at full width (phase 11): `Recognizer.random(
   ParaformerConfig(), seed=0, param_dtype=torch.bfloat16)` and, with
   PARAFORMER_QUANT=int8 set before construction, the W8A8 one, beside
   phase 3's f32 recognizer on the 8 rows: per mode K1 66 / K2 1 per
   transcribe, the forward's replay bit-equal to its eager call, card vs
   the same tree on the CPU (2 rows; bf16 by phase 3's rule, int8 held to
   the quantization's own error against f32: counts equal, logits within
   it, ids equal where the CPU's top-2 gap exceeds it), the transcribe
   wall (median, p95 of 12), the card's busy time and idle share, the
   weights' and the graph pool's bytes; under int8 the card's quantized
   tree equal to the CPU's, 200 `_int_mm` calls per eager forward (200
   `aten::mm` fewer than bf16) and as many int8 GEMM kernels in a
   replayed transcribe, the corpus CER of the int8 and bf16 ids against
   the f32 ids (`tools/wer.py`; random weights: printed, not gated);
   `_linear_int8` at the encoder's four shapes (8 x 167 rows) against the
   f32 `dot` with the int8 tensor-core and f32 bounds, card = CPU bit for
   bit there and at 9 rows; the quantized tree on the streaming path at
   S = 1 (9 rows: `_int_mm`'s padded path) and 64: 4 steps of the ticker
   step's halves card vs CPU by the int8 rule (fired counts part only
   where CIF's mass is within the quantization's own mass error of a
   firing threshold; at S = 1 every id equal),
   `BatchedChunkedASR`'s first 3 ticks beside a CPU ticker's (agreement
   printed), K1 50 / K2 1 per step, the step wall, the step's replay
   bit-equal to its eager call;
   `Synthesizer.random(seed=0, tiny=False, param_dtype=torch.bfloat16)` on
   phase 7's paragraph (RTF; `tools/mel_distance.py` on the card against
   phase 7's f32 audio; the first segment within TTS_PCM_LSB of the bf16
   trees on the CPU); TRACE_TRANSCRIBES bf16 transcribes under `runtime/
   profiling.trace_to` (the trace holds kernel events of both kernels) and
   `device_memory_stats()`;
11. the dispatch profile and the rehearsal (phase 12), which choose and
   check the `cuda` values of `runtime/autotune.py`: the probe
   (`measure_rtt_ms`, median of 7) and the profile `get_profile()`
   resolved at start-up, which must be `local`; the hub capacity sweep,
   for C in 64, 128, 192 and 256, every ticker built first, then timed in
   4 alternating rounds: `BatchedChunkedASR(capacity=C)` with C live
   sessions fed 8 chunks each (step wall median and p95, the card's busy
   time per step, K1 50 / K2 1 per step exactly) and
   `BatchedVadTicker(capacity=C)` (tick median), captures, capture
   seconds and pool bytes, and the rule's pick (the most sessions per ms
   of step + tick among the C with a step p95 under 100 ms, the smallest
   within 10 % of it); phase 7's paragraph under the four settings of
   (TTS_GROUP_BY_LENGTH, TTS_MEL_GROUP) (wall, first audio, busy,
   captures, pool bytes, max |d| in LSB against off/off; a grouping goes
   on only where it saves 5 %); phase 3's 8 rows quantized to PCM through
   the f32 and the int16 upload (fbank and ids bit-equal, K1 66 / K2 1 per
   transcribe, the wall; the chunked step at S = 64 with equal ids, K1 50
   / K2 1 per step; on only where it saves 5 %); USE_PALLAS_FRAMING=0
   raising on a CUDA tensor; then `tools/rehearse.py` over phase 8's mount
   as `cli rehearse --reconvert` runs it (every family converted with 0
   missing and 0 unmapped, exit status 0, the REST text equal to phase
   8's mounted service's with its launches held to its programs, a WS
   final, a TTS WAV; the seconds of convert, boot and each drive). Phases
   8 and 9 run their engines at 64 hub rows (VOICE_BATCH_CAPACITY), the
   rehearsal at the profile's;
12. the multi-card layer at full width (phase 13), each mesh a grid of
   `torch.device`s that repeats card 0 where it has more positions than
   the machine has cards (every card, too, where it has several): (a)
   phase 3's recognizer as `Recognizer(use_mesh=True)` over
   `serving_mesh()` and over 2 positions against `use_mesh=False` on the
   8 rows (ids and counts equal, packed floats within 1e-3, K1 66 / K2 1
   per position, the walls); (b) `BatchedChunkedASR(capacity=64,
   partials=True)` on a 2-position mesh, 16 sessions of 8 chunks then
   finalized, ids equal to the meshless ticker's, K1 50 / K2 1 per step;
   (c) phase 7's synthesizer with `use_mesh=True` on 3 segments, PCM
   within TTS_PCM_LSB of `use_mesh=False`; (d) `encode_seq_parallel` over
   4 positions on one 60 s row against `paraformer.encode` (max |d| within
   2e-4) and `transcribe_long_forward`'s ids equal to `forward`'s, K1 at
   the gathered V timed; (e) `encode_pipelined`, 49 layers in 7 stages,
   8 microbatches of phase 10's 8 rows: outputs within 1e-4 and the stage
   gradients (of Σ y·r, r fixed) within 1e-3 of each leaf's norm against
   the plain encoder's, K1 and K1's backward launches, both kernels timed at the
   microbatch's V view; (f) one dp + tp step on `make_2d_mesh(4,
   model_parallel=2)` against the single-device eager step (loss within
   rel 1e-4, gradients within 1e-2 of each leaf's norm, the updated
   parameters by MESH_TP_UPDATE_TOL), the data replicas bit-equal, and a
   `remat=True` step against the plain one. Two positions that share a
   card give no multi-card speed figure;
13. the reference's remaining serving paths at full width (phase 14), on
   phase 3's weights, TF32 off: (a) `BatchedChunkedASR(capacity=64,
   fused=False)` (the host-frontend ticker: one fbank program per ready
   count over 24-frame quanta of [n, 4080] audio, LFR drained per session
   on the host, a full-capacity encoder + CIF step) on phase 4's S = 16
   sessions cut to 8 chunks: K1 50 per step and K2 1 per fbank call, held
   to the steps and calls; sessions 0 and 1 against a per-session
   `OnlineRecognizer` on the card (fired counts equal, embeddings within
   1e-3 of each one's max |x|); step and tick walls (median, p95), the
   card's busy share of a tick (torch.profiler over 3 ticks), beside the
   fused ticker's on the same sessions and phase 4's S = 16 figures; (b)
   `BatchedChunkedASR(capacity=64, partials=True, bucketed=False)` and the
   bucketed ticker on the same sessions, finalized: ids equal, K1 50 / K2
   1 per step; (c) phase 7's synthesizer built under TTS_TWO_PHASE=0 beside
   a two-phase one on its weights, on the 14-segment paragraph: per batch
   no probe and one synthesis program, sample counts equal to two-phase's,
   PCM within TTS_PCM_LSB wherever two-phase's t_mel was the cap; the
   walls and the graph pools of both. K2 at the unfused quantum [64,
   4080] → 24 frames joins phase 2;
14. the `streaming`, `service`, `tts`, `checkpoints`, `entry_points`,
   `graphs` (per program owner, as first seen by a phase: programs,
   captures, capture seconds, replays, graph pool bytes at the phase's
   end), `train`, `precision`, `dispatch`, `mesh` and `kernels` JSON
   lines, then
   the result line {"ok": true, "device": {"platform": "gpu", "kind": ...,
   "count": ...}}.

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
    """(memory bytes/s, float32 flop/s outside the tensor cores, dense int8
    tensor-core op/s) from NVIDIA's data sheets; unknown cards count as the
    H100 SXM."""
    n = name.upper()
    if "H200" in n:
        return 4.8e12, 67e12, 1979e12
    if "H100" in n and "PCIE" in n:
        return 2.0e12, 51e12, 1513e12
    if "H100" in n and "NVL" in n:
        return 3.9e12, 60e12, 1671e12
    return 3.35e12, 67e12, 1979e12


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
    """The profile's kernels and copies on the card; user annotations (such
    as `Optimizer.step`'s, which span kernels) are left out."""
    return [e for e in prof.key_averages()
            if "CUDA" in str(getattr(e, "device_type", ""))
            and not getattr(e, "is_user_annotation", False)]


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


# K1's backward at the fine-tuning path's shapes: the encoder's V view of
# [8, 167, 1536] and the decoder's [8, k_max 32, 512], K 11, pad (5, 5)
K1_TRAIN_SITES = {"encoder": 167, "decoder": 32}


def conv_backward(torch, pad, which: str):
    """The library yardstick of K1's backward: one
    `torch.ops.aten.convolution_backward` of the depthwise conv, the input
    gradient (dx, without the residual and masks), the weight gradient (dw)
    or both."""
    def library(x, g, w):
        mask = [which in ("dx", "both"), which in ("dw", "both"), False]
        return torch.ops.aten.convolution_backward(
            g.transpose(1, 2), x.transpose(1, 2), w, None, [1], [pad[0]],
            [1], False, [0], x.shape[-1], mask)
    return library


def k1_backward_case(torch, site: str, dtype, seed: int):
    """x as the path passes it (the encoder: the V third of a qkv buffer
    that requires grad; the decoder: a contiguous leaf), w, a length mask
    and the incoming gradient g of K1's output."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, t, d = 8, K1_TRAIN_SITES[site], K1_D
    width = 3 * d if site == "encoder" else d
    src = torch.randn((b, t, width), generator=gen, device=dev).to(dtype)
    w = torch.randn((d, 1, K1_K), generator=gen, device=dev) * 0.02
    g = torch.randn((b, t, d), generator=gen, device=dev).to(dtype)
    lens = torch.tensor([t, t * 3 // 4, t // 3, t, t // 2, t - 7,
                         t * 2 // 3, t // 4], device=dev)
    mask = (torch.arange(t, device=dev)[None] < lens[:, None]).float()
    return src, w, g, mask


def replay_equal(torch, fn, want):
    """fn() captured in a CUDA graph on a side stream (after one eager warm-up
    call there), replayed twice → the graph if each replay's outputs equal
    `want` bit for bit, else None."""
    from toolbox_for_asr_and_tts_tpu_torch.ops.kernels import _build
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with _build.tallied():
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = fn()
    same = True
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        same &= all(torch.equal(a, b) for a, b in zip(out, want))
    return graph if same else None


def check_k1_backward(torch, peaks, floor_ms: float):
    """K1 under autograd at the fine-tuning shapes, through
    `FsmnDepthwiseFn`: one backward is one launch of K1's backward kernel
    (dx and dw) and no K1 launch. f32 dx equal bit for bit to the plain
    version with the taps reversed and the pads swapped, and within 1e-6 of
    max|dx| of autograd of the plain version (another order of the same
    sums); dw within 1e-5 of max|dw| of `fsmn_conv_dw_plain`; bf16 within
    1e-2 of either; both bit-equal across two runs, the dw-only call's dw
    equal to the fused call's, and two replays of a captured call equal to
    the eager call. Device time of the fused call (its tickets' memset and
    the kernel), the fused call's graph replay, the dw-only call, the
    earlier route's form (the flip and K1 as dx, then the dw-only call),
    the plain version and the library's `convolution_backward` with both
    gradients, beside the bound."""
    from toolbox_for_asr_and_tts_tpu_torch.ops.kernels import fsmn_conv as k1
    from toolbox_for_asr_and_tts_tpu_torch.ops.kernels import (
        fsmn_conv_dw as kdw)
    pad_l, pad_r = K1_PAD
    rows = []
    for site in K1_TRAIN_SITES:
        for dtype, f32 in ((torch.float32, True), (torch.bfloat16, False)):
            src, w, g, mask = k1_backward_case(torch, site, dtype, seed=6)
            d = K1_D
            leaf = src.detach().requires_grad_(True)
            x = leaf[..., 2 * d:] if site == "encoder" else leaf
            wg = w.detach().clone().requires_grad_(True)
            y = k1.fsmn_depthwise(x, wg, pad_l, pad_r, mask)
            torch.cuda.synchronize()
            n1, n_dw = k1.launches, kdw.launches
            y.backward(g)
            torch.cuda.synchronize()
            n1, n_dw = k1.launches - n1, kdw.launches - n_dw
            require((n1, n_dw) == (0, 1), f"K1 backward {site}: {n1} K1 and "
                    f"{n_dw} backward launches, expected 0 and 1")
            dx = leaf.grad[..., 2 * d:] if site == "encoder" else leaf.grad
            require(site != "encoder" or not leaf.grad[..., :2 * d].any(),
                    "K1 backward: gradient outside the V third")
            xp = x.detach().contiguous().requires_grad_(True)
            wp = w.detach().clone().requires_grad_(True)
            k1.fsmn_depthwise_plain(xp, wp, pad_l, pad_r, mask).backward(g)
            xv = x.detach()
            dtype_s = str(dtype).split(".")[-1]
            if f32:
                require(torch.equal(dx, k1.fsmn_depthwise_plain(
                    g, w.flip(-1), pad_r, pad_l, mask)), f"K1 backward "
                    f"{site}: f32 dx is not the reversed-taps plain version's")

            def fused():
                return kdw.fsmn_conv_bwd(xv, g, w, pad_l, pad_r, mask)

            def dw_only():
                return kdw.fsmn_conv_dw(xv, g, K1_K, pad_l, mask)

            def split():
                return (kdw.fsmn_conv_bwd(xv, g, w, pad_l, pad_r, mask,
                                          need_dw=False)[0], dw_only())

            def plain():
                return kdw.fsmn_conv_bwd_plain(xv, g, w, pad_l, pad_r, mask)
            dx1, dw1 = fused()
            dx2, dw2 = fused()
            dwa, dwb = dw_only(), dw_only()
            dw_plain = kdw.fsmn_conv_dw_plain(xv, g, K1_K, pad_l, mask)
            torch.cuda.synchronize()
            require(torch.equal(dx1, dx2) and torch.equal(dw1, dw2)
                    and torch.equal(dwa, dwb), f"K1 backward {site} "
                    f"{dtype_s}: two runs differ")
            require(torch.equal(dwa, dw1), f"K1 backward {site} {dtype_s}: "
                    "the dw-only call's dw is not the fused call's")
            require(torch.equal(dx, dx1) and torch.equal(
                wg.grad, dw1.to(dtype).float()), f"K1 backward {site}: the "
                "Function's gradients are not the kernel's")
            graph = replay_equal(torch, fused, (dx1, dw1))
            require(graph is not None, f"K1 backward {site} {dtype_s}: a "
                    "graph replay differs from the eager call")
            errs = {}
            for name, got, want, tol in (
                    ("dx", dx, xp.grad, 1e-6 if f32 else 1e-2),
                    ("dw", dw1, dw_plain, 1e-5 if f32 else 1e-2)):
                err = (got.float() - want.float()).abs().max().item()
                scale = want.float().abs().max().item()
                require(err <= tol * scale, f"K1 backward {name} {site} "
                        f"{dtype_s}: max|err| {err} > {tol} x {scale}")
                errs[name] = (err, tol, scale)
            library = conv_backward(torch, K1_PAD, "both")
            wk = w.to(dtype)
            ms = device_ms(torch, fused)
            dw_ms = device_ms(torch, dw_only)
            replay_ms = device_ms(torch, graph.replay)
            split_ms = device_ms(torch, split)
            host_ms = call_ms(torch, fused)
            plain_ms = device_ms(torch, plain)
            library_ms = device_ms(torch, lambda: library(xv, g, wk))
            el = xv.element_size()
            b, t = xv.shape[:2]
            small = d * K1_K * 4 * 2 + mask.numel() * 4     # w, dw, mask
            bound_ms, bound_by = bound(3 * g.numel() * el + small,
                                       (4 * K1_K + 2) * b * t * d, peaks)
            dw_bound_ms, _ = bound(2 * g.numel() * el + small - d * K1_K * 4,
                                   2 * K1_K * b * t * d, peaks)
            row = dict(
                site=site, dtype=dtype_s, shape=[b, t, d, K1_K],
                pad=list(K1_PAD), masked=True, strided=xv.stride(1) != d,
                tile=list(kdw.tile_for(xv, g, K1_K)),
                max_abs_err=max(errs["dx"][0], errs["dw"][0]),
                max_abs_err_dx=errs["dx"][0], max_abs_err_dw=errs["dw"][0],
                tol_dx=errs["dx"][1], tol_dw=errs["dw"][1],
                scale_dx=errs["dx"][2], scale_dw=errs["dw"][2],
                dx_equal_reversed_plain=True if f32 else None,
                ms=ms, dw_only_ms=dw_ms, replay_ms=replay_ms,
                dx_by_k1_plus_dw_only_ms=split_ms, call_ms=host_ms,
                plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                dw_only_bound_ms=dw_bound_ms, library_ms=library_ms,
                launch_floor_ms=floor_ms, deterministic=True,
                replay_equal=True)
            rows.append(row)
            print(f"K1 backward {site} {dtype_s} x[{b},{t},{d}]"
                  f"{' (V view)' if row['strided'] else ''} K={K1_K} "
                  f"{row['tile']}: max|err| dx {errs['dx'][0]:.3g} (tol "
                  f"{errs['dx'][1]} x max {errs['dx'][2]:.3g}), dw "
                  f"{errs['dw'][0]:.3g} (tol {errs['dw'][1]} x max "
                  f"{errs['dw'][2]:.3g}); device: fused {ms * 1e3:.2f} us "
                  f"(graph replay {replay_ms * 1e3:.2f} us), dw only "
                  f"{dw_ms * 1e3:.2f} us, flip + K1 as dx + dw only "
                  f"{split_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} "
                  f"us, library (convolution_backward, both gradients) "
                  f"{library_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
                  f"({bound_by}; dw only {dw_bound_ms * 1e3:.2f} us), launch "
                  f"floor {floor_ms * 1e3:.2f} us; per call with host "
                  f"overhead {host_ms * 1e3:.2f} us", flush=True)
    return rows


# K1 and K2 at the streaming path's shapes (f32, as the path runs)
STREAM_S = 64                 # sessions of the largest bucket timed
VAD_CTX, VAD_T, VAD_D, VAD_K = 19, 40, 128, 20   # [cache ‖ h], lorder 20


def check_streaming_kernels(torch, peaks, floor_ms: float):
    """K1 in the chunked encoder (the V third of an [S, 9, 1536] qkv
    buffer, K 11, no mask) at S 64 and 1, and in FSMN-VAD's streaming step
    ([cache ‖ h] = [64, 19 + 40, 128], K 20, pad (19, 0), of which the path
    keeps rows 19 onward; yardstick: the reference's h + valid conv); K2 on
    the fused step's audio ring [64, 4320] → 25 frames, on the first
    0.4 s VAD tick [64, 6400] → 38 frames and on the unfused ticker's
    fbank quantum [64, 4080] → 24 frames."""
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
               check_k2(torch, peaks, STREAM_S, 6400, 38, "stream_vad_tick"),
               check_k2(torch, peaks, STREAM_S, 4080, 24,
                        "stream_unfused_quantum")]
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


BWD_SWEEP = dict(channels=(16, 32, 64), frame_blocks=(1, 2, 3, 4, 6, 11),
                 per_thread=(2, 4, 8, 16))


def sweep_dw(torch):
    """The device time of K1's backward kernel (dx and dw, one launch) for
    each tile (channels per block x frame blocks x frames per thread, K 11)
    at both fine-tuning shapes and at batch 64 of the encoder's (f32, x as
    the path passes it); every tile is first held against the plain
    version (dx bit-equal, dw within 1e-5 of max|dw|). Then, at the
    wrapper's tile, the dw-only call and the time to each of the kernel's
    steps (`fsmn_conv_dw.launch(..., exit_after=p)`: an instantiation whose
    blocks all leave at the start, after staging, after the dw partials or
    after dx and the ticket) with dx and dw."""
    from toolbox_for_asr_and_tts_tpu_torch.ops.kernels import (
        fsmn_conv as k1, fsmn_conv_dw as kdw)
    pad_l, pad_r = K1_PAD
    for site, b in (("encoder", 8), ("decoder", 8), ("encoder", 64)):
        src, w, g, mask = k1_backward_case(torch, site, torch.float32, 7)
        if b != 8:
            src, g, mask = (a.repeat(b // 8, *[1] * (a.dim() - 1))
                            for a in (src, g, mask))
        x = src[..., 2 * K1_D:] if site == "encoder" else src
        t = x.shape[1]
        want_dx = k1.fsmn_depthwise_plain(g, w.flip(-1), pad_r, pad_l, mask)
        want_dw = kdw.fsmn_conv_dw_plain(x, g, K1_K, pad_l, mask)
        scale = want_dw.abs().max().item()
        chosen = kdw.tile_for(x, g, K1_K)
        tiles = {chosen}
        for c in BWD_SWEEP["channels"]:
            for n_tb in BWD_SWEEP["frame_blocks"]:
                for per in BWD_SWEEP["per_thread"]:
                    tiles.add(kdw.make_tile(t, K1_K, chosen.vec, c, n_tb, per,
                                            K1_K))
        times = {}
        for tile in sorted(tiles):
            def fn(tile=tile):
                return kdw.launch(x, g, w, K1_K, pad_l, mask, tile)
            dx, dw = fn()
            torch.cuda.synchronize()
            require(torch.equal(dx, want_dx), f"bwd sweep {site} B {b} "
                                              f"{tile}: dx differs")
            err = (dw - want_dw).abs().max().item()
            require(err <= 1e-5 * scale, f"bwd sweep {site} B {b} {tile}: "
                                         f"dw max|err| {err}")
            times[tile] = device_ms(torch, fn)
        dw_ms = device_ms(torch, lambda: kdw.fsmn_conv_dw(x, g, K1_K, pad_l,
                                                          mask))
        steps = [device_ms(torch, lambda p=p: kdw.launch(
            x, g, w, K1_K, pad_l, mask, chosen, exit_after=p))
            for p in range(1, len(kdw.PHASES) + 1)]
        best = min(times, key=times.get)
        print(f"bwd sweep {site} x[{b},{t},{K1_D}] ({len(times)} tiles): "
              f"best {tuple(best)} {times[best] * 1e3:.2f} us, chosen "
              f"{tuple(chosen)} {times[chosen] * 1e3:.2f} us; dw only at the "
              f"chosen tile {dw_ms * 1e3:.2f} us", flush=True)
        print("  dx and dw, leaving " + ", ".join(
            f"{phase} {ms * 1e3:.2f} us"
            for phase, ms in zip(kdw.PHASES, steps))
            + f", whole {times[chosen] * 1e3:.2f} us", flush=True)
        for tile, ms in sorted(times.items(), key=lambda kv: kv[1])[:12]:
            print(f"  channels {tile.channels:2d} frames "
                  f"{tile.block_frames():3d} ({tile.threads_t:2d} x "
                  f"{tile.per_thread}) blocks "
                  f"{b * -(-K1_D // tile.channels) * -(-t // tile.block_frames()):5d}: "
                  f"{ms * 1e3:.2f} us")


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


# ------------------------------------------- the program layer (graphs)
GRAPHS = {}   # id(owner) → its stats at the last snapshot, and its phase


def graph_snapshot(phase: str) -> None:
    """Record every live program owner's captures, capture seconds,
    replays and graph pool bytes (`runtime/graphs.py::report`); an owner
    keeps the phase that first saw it."""
    from toolbox_for_asr_and_tts_tpu_torch.runtime import graphs
    for row in graphs.report():
        key = row.pop("id")
        GRAPHS[key] = dict(row, phase=GRAPHS.get(key, {}).get("phase", phase))


def graphs_line():
    rows = sorted(GRAPHS.values(), key=lambda r: (r["phase"], r["owner"]))
    return dict(owners=rows,
                captures=sum(r["captures"] for r in rows),
                capture_s=sum(r["capture_s"] for r in rows),
                replays=sum(r["replays"] for r in rows),
                pool_bytes=sum(r["pool_bytes"] or 0 for r in rows))


def _flat(torch, tree):
    from toolbox_for_asr_and_tts_tpu_torch.models.convert import tree_map
    out = []
    tree_map(out.append, tree)
    return out


def equal_outputs(torch, got, want, what: str) -> int:
    """Every tensor of a replay's outputs bit-equal to the eager call's;
    returns how many were compared."""
    a, b = _flat(torch, got), _flat(torch, want)
    require(len(a) == len(b) and a, f"{what}: {len(a)} outputs vs {len(b)}")
    for i, (x, y) in enumerate(zip(a, b)):
        require(x.shape == y.shape and x.dtype == y.dtype,
                f"{what} output {i}: {x.dtype} {tuple(x.shape)} vs "
                f"{y.dtype} {tuple(y.shape)}")
        if not torch.equal(x, y):
            d = (x.double() - y.double()).abs().max().item()
            raise PhaseError(f"{what} output {i}: the replay differs from "
                             f"the eager call (max |d| {d:.3g})")
    return len(a)


def replay_vs_eager(torch, prog, *inputs, what: str, state=()) -> int:
    """A program's replay against its eager function on the same inputs,
    bit for bit (TF32 off). `state`: tensors the program updates in place
    (a ticker's rows): both runs start from the same values, the updates
    must agree too, and the state is left as it was found."""
    dev = prog.owner.device
    require(prog.graph is not None, f"{what}: not a captured graph")
    before = [t.clone() for t in state]
    got = prog(*inputs)
    after = [t.clone() for t in state]
    with torch.inference_mode():
        for t, b in zip(state, before):
            t.copy_(b)
        want = prog.fn(*[torch.as_tensor(a).to(dev, dt)
                         for a, (_, dt) in zip(inputs, prog.specs)])
        torch.cuda.synchronize()
        n = equal_outputs(torch, got, want, what)
        n += equal_outputs(torch, after, [t.clone() for t in state],
                           what + " state") if state else 0
        for t, b in zip(state, before):
            t.copy_(b)
    return n


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
    batch, lens = reco.bucketer.pad_batch(wavs)
    prog = reco._fn_for(*batch.shape)
    n_out = replay_vs_eager(torch, prog, batch, lens,
                            what="recognizer forward")
    dev = prog(batch, lens)
    t_lfr, _ = reco._bucket_shapes(batch.shape[1])
    counts = dev["token_count"].cpu().numpy()
    k_b = min(-(-int(counts.max()) // reco.K_BUCKET) * reco.K_BUCKET,
              dev["embeds"].shape[1])
    n_out += replay_vs_eager(
        torch, reco._logits_fn(batch.shape[0], t_lfr, k_b),
        *(dev[k] for k in reco._RESCORING_INPUTS), what="recognizer logits")
    print(f"replay vs eager: the forward program (8 x 10 s) and the "
          f"rescoring program (k_b {k_b}) bit-equal to their eager calls "
          f"({n_out} outputs: ids, counts, fire frames, f32 enc and embeds, "
          f"bf16 logits)", flush=True)
    in_replay = {}
    if profile:
        in_replay = profile_transcribe(torch, reco, wavs,
                                       rtf["plain"] * audio_s * 1e3)
        time_rescoring(torch, reco, wavs)
    graph_snapshot("main")
    return reco, wavs, {"K1": k1_n, "K2": k2_n, "K1_rescoring": k1_hw,
                        "K2_rescoring": k2_hw, "in_replay": in_replay}, rtf


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
    return kernels_in_replay(rows, "one transcribe's replay")


def kernels_in_replay(rows, what: str):
    """K1's and K2's mean device time per launch among a profile's kernels
    (the launches of graph replays), in ms."""
    out = {}
    for name, sym in (("fsmn_conv", "fsmn_conv_kernel"),
                      ("frame_window", "frame_window_kernel")):
        hits = [e for e in rows if sym in e.key]
        n = sum(e.count for e in hits)
        if n:
            out[name] = dict(
                ms=sum(e.self_device_time_total for e in hits) / 1e3 / n,
                launches=n)
    print(f"profile: inside {what}: " + ", ".join(
        f"{k} {v['ms'] * 1e3:.2f} us x {v['launches']}"
        for k, v in out.items()), flush=True)
    return out


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


def compare_cpu(torch, reco, wavs, cpu=None, what: str = "card vs cpu"):
    """The card's forward pass vs the same port on the CPU (`cpu`, else
    `Recognizer.random(seed=0)` there), rows CPU_ROWS: token counts equal,
    tokens equal wherever the CPU's top-2 logit gap exceeds 1e-3 and in at
    least 99.9 % of places, fire frames equal but at a cumsum within 1e-4
    of a token boundary. Returns the comparison's numbers."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import Recognizer
    if cpu is None:
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
    print(f"{what}: token_count {count.tolist()} equal; tokens equal "
          f"{same[valid].sum()}/{valid.sum()} ({share:.4%}), "
          f"{(~same[valid]).sum()} differ (all with top-2 gap <= 1e-3); "
          f"fire frames differing near a boundary: {near}; "
          f"max|dlogit| {dlog:.3g} of max|logit| "
          f"{np.abs(logits).max():.3g}, max|dalpha| {dal:.3g}, max|denc| "
          f"{denc:.3g}", flush=True)
    return dict(rows=list(CPU_ROWS), token_count=count.tolist(),
                tokens_equal=int(same[valid].sum()),
                tokens_differ=int((~same[valid]).sum()),
                fire_frames_near_boundary=near, max_abs_dlogit=float(dlog),
                max_abs_logit=float(np.abs(logits).max()),
                max_abs_dalpha=float(dal), max_abs_denc=float(denc))


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


def wall_stats(walls_s):
    """Median and p95 (ms) of walls in seconds, and their count."""
    import numpy as np
    ms = [w * 1e3 for w in walls_s]
    return dict(median_ms=float(np.median(ms)),
                p95_ms=float(np.percentile(ms, 95)), n=len(ms))


def tick_stats(ticks):
    """`wall_stats` of the ticks after the first in which every session
    was fed (None without one)."""
    walls = [w for w, _, full in ticks[1:] if full]
    return wall_stats(walls) if walls else None


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
    return dict(busy_ms_per_step=busy, launches_per_step=launches, steps=n,
                in_replay=kernels_in_replay(
                    rows, f"{len(audios)}-session steps' replays"))


def tick_replay_checks(torch, asr, vad):
    """The chunked step at prefix buckets 1 and 64 and the VAD step at 64
    rows x 40 frames: each replay bit-equal to its eager function from the
    same state, state updates included (state restored after)."""
    import numpy as np
    rng = np.random.default_rng(7)
    n = 0
    for b in (1, asr.capacity):
        audio = (0.1 * rng.standard_normal((b, asr.chunk_samples))).astype(
            np.float32)
        n += replay_vs_eager(torch, asr._tick_fn(b), audio,
                             np.ones((b,), np.float32),
                             what=f"chunked step b{b}",
                             state=list(asr.state.values()))
    feats = rng.standard_normal((vad.capacity, 40, vad.cfg.input_dim)).astype(
        np.float32)
    n += replay_vs_eager(torch, vad._step_fn(vad.capacity, 40), feats,
                         np.ones((vad.capacity,), bool),
                         what="VAD step", state=[vad.cache])
    print(f"replay vs eager: chunked steps at 1 and {asr.capacity} rows and "
          f"the VAD step at {vad.capacity} rows bit-equal to their eager "
          f"calls ({n} outputs and state leaves)", flush=True)
    return n


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
    asr.warm()                 # every pow-2 prefix's program, and the tail
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
                   tick_all_live=tick_stats(ticks),
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
    out["vad"], vad = vad_path(torch, card)
    out["replay_vs_eager_outputs"] = tick_replay_checks(torch, asr, vad)
    graph_snapshot("streaming")
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
    vad.warm()          # every fbank and step program of 0.4 s chunks
    audios = session_audio(64, seed=164)
    slots = [vad.join() for _ in audios]

    feats_s = []
    batched_feats = vad._batched_feats

    def timed_feats(slots_):
        t0 = time.perf_counter()
        out = batched_feats(slots_)
        feats_s.append(time.perf_counter() - t0)
        return out
    vad._batched_feats = timed_feats   # the fbank replay and the LFR drain

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
    del vad._batched_feats
    n = len(walls)
    require(k1_n == cfg.fsmn_layers * n and k2_n == n,
            f"VAD: K1 {k1_n}, K2 {k2_n} in {n} ticks")
    rest = [w * 1e3 for w in walls[1:]]
    feats_ms = [f * 1e3 for f in feats_s[1:]]
    row = dict(sessions=64, ticks=n, k1_per_tick=k1_n / n,
               k2_per_tick=k2_n / n, tick_median_ms=float(np.median(rest)),
               tick_p95_ms=float(np.percentile(rest, 95)),
               features_median_ms=float(np.median(feats_ms)),
               speech_decisions=int(speech))
    print(f"streaming VAD S=64: {n} ticks, K1 {k1_n / n:g}/tick, K2 "
          f"{k2_n / n:g}/tick; tick wall median {row['tick_median_ms']:.2f} "
          f"ms, p95 {row['tick_p95_ms']:.2f} ms, of it the features (fbank "
          f"replay, fetch, 64 host LFR drains) median "
          f"{row['features_median_ms']:.2f} ms; {speech} speech decisions "
          f"on {card}", flush=True)
    return row, vad


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
    # as build_engines: the ticker hubs capture their programs before the
    # gather hubs' threads start
    vad_factory = E._vad_factory(capacity=64)
    streaming_factory = E._streaming_factory(reco, capacity=64)
    engines = VoiceEngines(
        diarizer=H.FinalizeHub(Diarizer(reco, sv, punctuator=punc)),
        kws=H.KwsHub(kws), verifier=sv, vad_factory=vad_factory,
        streaming_factory=streaming_factory)
    torch.cuda.synchronize()
    print(f"service: engines on {sv.device}, {punc.device}, {kws.device} "
          f"built in {time.perf_counter() - t0:.1f} s (ChunkedHub and VadHub "
          f"programs captured at every pow-2 occupancy to 64, the ChunkedHub "
          f"pipelined: "
          f"{engines.streaming_factory.hub.ticker.pipelined}; "
          f"CT-Transformer {punc.cfg.num_layers} "
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
        out = {"S1": sessions_run(torch, port, engines, models, 1)}
        # S = 16 under the serving default (CHUNKED_PIPELINE=1: the first
        # run also captures the FinalizeHub's new batch buckets), then with
        # the ticker's pipelined flag off (what CHUNKED_PIPELINE=0 sets),
        # then pipelined again
        ticker = engines.streaming_factory.hub.ticker
        require(ticker.pipelined, "the ChunkedHub does not pipeline by "
                "default")
        try:
            for run, piped in (("S16_first", True), ("S16_unpipelined", False),
                               ("S16", True)):
                ticker.pipelined = piped
                out[run] = sessions_run(torch, port, engines, models, 16)
                out[run]["pipelined"] = piped
        finally:
            ticker.pipelined = True
        print("service S=16 partial latency median / p95: pipelined "
              + ", ".join(f"{out[r]['partial']['median_ms']:.1f} / "
                          f"{out[r]['partial']['p95_ms']:.1f} ms ({r})"
                          for r in ("S16_first", "S16"))
              + f"; unpipelined {out['S16_unpipelined']['partial']['median_ms']:.1f}"
              f" / {out['S16_unpipelined']['partial']['p95_ms']:.1f} ms on "
              f"{card}", flush=True)
        out["four_modes"] = four_mode_session(torch, port, engines, models)
        out["rest"] = rest_check(torch, port, engines, models)
        if profile:
            out["profile_S16"] = profile_service(torch, port, engines,
                                                 models)
    finally:
        server.stop()
    out["launches"] = service_launches(torch, sv, punc, kws)
    out["card_vs_cpu"] = service_card_vs_cpu(torch, sv, punc, kws)
    out["replay_vs_eager_outputs"] = service_replay_checks(torch, sv, punc,
                                                           kws)
    graph_snapshot("service")
    return out, models


def service_replay_checks(torch, sv, punc, kws):
    """The punctuation (8 x 64 words), embed (16 x 1 s) and KWS (64 x 1.6 s)
    programs at full width: each replay bit-equal to its eager call."""
    import numpy as np
    rng = np.random.default_rng(8)
    ids = rng.integers(0, punc.cfg.vocab_size, (8, 64)).astype(np.int32)
    n = replay_vs_eager(torch, punc._fn(8, 64), ids,
                        np.full((8,), 64, np.int32), what="punctuation")
    wav = (0.1 * rng.standard_normal((16, SR))).astype(np.float32)
    n += replay_vs_eager(torch, sv._fn(16, SR), wav,
                         np.full((16,), SR, np.int64), what="embed")
    win = (0.1 * rng.standard_normal((64, 25600))).astype(np.float32)
    n += replay_vs_eager(torch, kws._batch_fn(64, 25600), win,
                         what="KWS batch")
    print(f"replay vs eager: punctuation (8 x 64), embed (16 x 1 s) and KWS "
          f"(64 x 1.6 s) programs bit-equal to their eager calls ({n} "
          f"outputs)", flush=True)
    return n


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
    """Pinned whatever the environment and the dispatch profile say: the
    NAR decoder (or `mode`), one call per batch."""
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
    arrays = tts_batch(synth, segments[:1])
    graph_step = pnca_graph_steps(torch, synth, arrays)
    tts_pin(synth, "pnca")
    try:
        n_out = replay_vs_eager(
            torch, synth._synth_prog(1, arrays[0].shape[1], PNCA_T_MELS[0]),
            *arrays, what="PNCA synthesis")
    finally:
        tts_pin(synth, "nar")
    print(f"replay vs eager: the PNCA synthesis program (t_mel "
          f"{PNCA_T_MELS[0]}) bit-equal to its eager call ({n_out} output: "
          f"int16 PCM and mel lengths)", flush=True)
    ids, lens, spk = (torch.from_numpy(a).to(synth.device) for a in arrays)

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
               ms_per_step=per_step, graph=graph_step,
               replay_vs_eager_outputs=n_out)
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
          f"t_mel {PNCA_T_MELS}: {per_step:.3f} ms per step eagerly, "
          f"{graph_step['ms_per_step']:.3f} ms per step in a graph replay "
          f"({graph_step['replay_ms']} ms)"
          + (f", {out['launches_per_step']:.1f} launches per step "
             f"({out['launches']})" if profile else "") + f" on {card}",
          flush=True)
    return out


def pnca_graph_steps(torch, synth, arrays):
    """`forward_ar`'s mel captured as one graph per t_mel (the PNCA scan of
    ⌈t_mel / r⌉ steps inside it, as in the synthesis program): the replay's
    wall at PNCA_T_MELS (median of 5, host clock ending in a synchronize);
    the difference over the extra steps is one step's cost."""
    from toolbox_for_asr_and_tts_tpu_torch.models import sambert
    from toolbox_for_asr_and_tts_tpu_torch.runtime.graphs import Programs
    progs = Programs(synth.device, "pnca-measure")
    specs = [(a.shape, torch.from_numpy(a).dtype) for a in arrays]
    r = synth.acfg.outputs_per_step
    walls, capture_s = [], []
    for t in PNCA_T_MELS:
        t0 = time.perf_counter()
        prog = progs.get(t, lambda t=t: ((lambda i, n, s: sambert.forward_ar(
            synth.ap, i, n, s, synth.acfg, t_mel=t)["mel"]), specs))
        capture_s.append(time.perf_counter() - t0)
        prog(*arrays, read=lambda m: None)
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prog(*arrays, read=lambda m: None)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        walls.append(statistics.median(ts))
    steps = [-(-t // r) for t in PNCA_T_MELS]
    return dict(replay_ms={str(t): w for t, w in zip(PNCA_T_MELS, walls)},
                capture_s={str(t): c for t, c in zip(PNCA_T_MELS, capture_s)},
                ms_per_step=(walls[1] - walls[0]) / (steps[1] - steps[0]))


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
    graph_snapshot("tts")
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
                              rest_text=rest["text"],
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
    graph_snapshot("checkpoints")
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
    graph_snapshot("entry_points")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"entry points phase: {out['phase_s']:.1f} s on {card}", flush=True)
    return out


# ---------------------------------------------------------------- main
# ------------------------------------------- phase 10: fine-tuning
FT_STEPS = 8                 # steps on one fixed batch: the loss must fall
FT_RESUME_AT = 4             # saved here, restored into a fresh tree
FT_K_MAX = 32
FT_LR = 1e-4
FT_CPU_SECONDS = 3.0         # 2 rows cut to this, card vs CPU gradients
FT_CPU_ROWS = (0, 1)
FT_GRAD_REL = 1e-3           # card vs CPU: |g_card - g_cpu| <= this · |g_cpu|
                             # per leaf (66 layers of f32 GEMMs summed in
                             # other orders, cuBLAS vs the CPU's BLAS)


def ft_manifest(root: str, wavs, tokenizer) -> str:
    """The 8 rows of `make_wavs` as 16-bit WAVs under `root`, with random
    target texts from a fixed seed (3 tokens per second of audio, at most
    k_max, ids past the specials), in the CLI's JSONL manifest."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.utils.audio import write_wav
    rng = np.random.default_rng(9)
    path = os.path.join(root, "train.jsonl")
    with open(path, "w", encoding="utf-8") as f:
        for i, w in enumerate(wavs):
            wav = os.path.join(root, f"row{i}.wav")
            write_wav(wav, w, SR)
            n = min(FT_K_MAX, max(1, int(3 * len(w) / SR)))
            ids = rng.integers(4, len(tokenizer.tokens), n)
            f.write(json.dumps({"wav": wav, "text": "".join(
                tokenizer.tokens[j] for j in ids)}, ensure_ascii=False) + "\n")
    return path


def ft_card_vs_cpu(torch, cfg, params, items):
    """The gradients of one step on the card against the same port on the
    CPU (the same seed-0 tree, the same CPU-computed features of 2 rows cut
    to 3 s), before the card's tree takes a step."""
    from toolbox_for_asr_and_tts_tpu_torch.models import paraformer
    from toolbox_for_asr_and_tts_tpu_torch.parallel import trainstep as ts
    from toolbox_for_asr_and_tts_tpu_torch.tools import finetune
    n = int(FT_CPU_SECONDS * SR)
    rows = [(items[i][0][:n], items[i][1][:int(3 * FT_CPU_SECONDS)])
            for i in FT_CPU_ROWS]
    batch = finetune._features(rows, cfg.frontend, FT_K_MAX // 2, "cpu")
    t0 = time.perf_counter()
    cpu = paraformer.init_params(cfg, torch.Generator().manual_seed(0))
    for p in ts.param_leaves(cpu):
        p.requires_grad_(True)
    out = {}
    for name, tree in (("card", params), ("cpu", cpu)):
        dev = ts.param_leaves(tree)[0].device
        b = {k: v.to(dev) for k, v in batch.items()}
        loss, _ = ts.paraformer_loss(tree, b["feats"], b["feat_lens"],
                                     b["targets"], b["target_lens"], cfg)
        loss.backward()
        leaves = ts.param_leaves(tree)
        out[name] = (loss.item(), [p.grad.cpu() for p in leaves])
        for p in leaves:
            p.grad = None
    (l_card, g_card), (l_cpu, g_cpu) = out["card"], out["cpu"]
    floor = 1e-7 * max(g.norm().item() for g in g_cpu)
    worst = max(((a - b).norm() / max(b.norm().item(), floor)).item()
                for a, b in zip(g_card, g_cpu))
    dloss = abs(l_card - l_cpu) / abs(l_cpu)
    require(dloss <= 1e-5, f"fine-tuning card vs cpu: loss {l_card} vs "
                           f"{l_cpu}")
    require(worst <= FT_GRAD_REL, f"fine-tuning card vs cpu: a leaf's "
                                  f"gradient differs by {worst:.3g} of its norm")
    print(f"fine-tuning card vs cpu: rows {list(FT_CPU_ROWS)} cut to "
          f"{FT_CPU_SECONDS} s, loss {l_card:.6f} vs {l_cpu:.6f} (rel "
          f"{dloss:.3g}), worst leaf |g_card - g_cpu| / |g_cpu| {worst:.3g} "
          f"over {len(g_cpu)} leaves (tol {FT_GRAD_REL}), "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return dict(rows=list(FT_CPU_ROWS), seconds=FT_CPU_SECONDS,
                loss_rel=dloss, worst_leaf_rel=worst, tol=FT_GRAD_REL,
                leaves=len(g_cpu))


def ft_steps(torch, step, params, opt, items, cfg, on_step=None):
    """FT_STEPS steps on one fixed batch (all rows, in order), each its
    features (`finetune._features`, K2) and its step, with the launch
    counters zeroed just before and read just after; the loss fetched
    ends each step's wall. `on_step(i)` runs before step i."""
    from toolbox_for_asr_and_tts_tpu_torch.ops.kernels import fsmn_conv as k1
    from toolbox_for_asr_and_tts_tpu_torch.ops.kernels import (
        fsmn_conv_dw as kdw)
    from toolbox_for_asr_and_tts_tpu_torch.ops.kernels import frame_window as k2
    from toolbox_for_asr_and_tts_tpu_torch.tools import finetune
    dev = torch.device("cuda")
    losses, walls, launches = [], [], []
    for i in range(FT_STEPS):
        if on_step is not None:
            on_step(i)
        torch.cuda.synchronize()
        k1.launches = kdw.launches = k2.launches = 0
        t0 = time.perf_counter()
        batch = finetune._features(items, cfg.frontend, FT_K_MAX, dev)
        params, opt, m = step(params, opt, batch)
        losses.append(m["loss"].item())
        walls.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        launches.append((k1.launches, kdw.launches, k2.launches))
    return losses, walls, launches, batch


def profile_train_step(torch, step, params, opt, items, cfg, wall_ms: float,
                       what: str = "eager"):
    """Device time of one fine-tuning step (`what`: "eager", or "captured"
    for a replay of `capture_train_step`'s graph) by kernel
    (torch.profiler), features included, against the unprofiled median
    step wall; K1's and dw's per launch."""
    from torch.profiler import ProfilerActivity, profile
    from toolbox_for_asr_and_tts_tpu_torch.tools import finetune
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        batch = finetune._features(items, cfg.frontend, FT_K_MAX,
                                   torch.device("cuda"))
        step(params, opt, batch)
        torch.cuda.synchronize()
    rows = _device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    require(busy_ms > 0, "profiler saw no device time")
    n = sum(e.count for e in rows)
    print(f"profile: one {what} fine-tuning step, device busy "
          f"{busy_ms:.1f} ms of {wall_ms:.1f} ms unprofiled median wall "
          f"(idle share {100 * (1 - busy_ms / wall_ms):.1f}%), {n} kernel "
          f"launches")
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:15]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms "
              f"{e.count:5d}x  {e.key[:90]}")
    out = dict(busy_ms=busy_ms, wall_ms=wall_ms, launches=n,
               idle_share=1 - busy_ms / wall_ms)
    for name, sym in (("fsmn_conv", "fsmn_conv_kernel"),
                      ("fsmn_conv_dw", "fsmn_bwd_"),
                      ("frame_window", "frame_window_kernel")):
        hits = [e for e in rows if sym in e.key]
        k = sum(e.count for e in hits)
        if k:
            out[name] = dict(ms_total=sum(e.self_device_time_total
                                          for e in hits) / 1e3, launches=k)
    for v in out.values():
        if isinstance(v, dict):
            v["us_per_launch"] = 1e3 * v["ms_total"] / v["launches"]
    print(f"profile: inside one {what} step: " + ", ".join(
        f"{k} {v['ms_total']:.3f} ms over {v['launches']} kernel launches "
        f"({v['us_per_launch']:.2f} us each)"
        for k, v in out.items() if isinstance(v, dict)), flush=True)
    return out


FT_REMAT_STEPS = 3           # steps of the remat pair (eager and captured;
                             # the captured run's third is its first replay)
FT_ADAMW_STEPS = 3           # capturable AdamW against optax's formula
FT_ADAMW_ATOL = 1e-2         # in units of lr (test_three_adamw_steps_match_
                             # optax's bound on the parameters)
FT_CLI_STEPS = 4             # the CLI on the 8-row manifest, batch 8: enough
                             # draws for a T to come back twice
FT_MIXED_ROWS = 1000         # the mixed-length manifest of the shape count:
FT_MIXED_SECONDS = (1.0, 20.0)   # durations uniform over the CLI's --max-secs
FT_MIXED_STEPS = (100, 1000)     # the CLI's default --steps, and ten times it
FT_MIXED_BATCHES = (4, 8)        # the CLI's default --batch, and phase 10's


_FT_TREES = {}   # geometry → its seed-0 tree on the card, drawn once


def ft_fresh(torch, cfg):
    """A fresh seed-0 tree on the card (`Recognizer.random(cfg, seed=0)`'s
    weights: drawn on the CPU once per geometry, then cloned on the card),
    its optimizer (`adamw(FT_LR)`) and its eager step."""
    import dataclasses
    from toolbox_for_asr_and_tts_tpu_torch.models import paraformer
    from toolbox_for_asr_and_tts_tpu_torch.models.convert import (
        tree_map, tree_to)
    from toolbox_for_asr_and_tts_tpu_torch.parallel import trainstep as ts
    key = repr(dataclasses.replace(cfg, remat=False))
    if key not in _FT_TREES:
        _FT_TREES[key] = tree_to(paraformer.init_params(
            cfg, torch.Generator().manual_seed(0)), torch.device("cuda"))
    params = tree_map(torch.clone, _FT_TREES[key])
    init_opt, step = ts.make_train_step(cfg, ts.adamw(FT_LR))
    return params, init_opt(params), step


def ft_state(torch, params, opt):
    """Every parameter, then every AdamW state tensor, in the tree's
    order."""
    from toolbox_for_asr_and_tts_tpu_torch.parallel import trainstep as ts
    leaves = ts.param_leaves(params)
    return leaves + [opt.state[p][k] for p in leaves
                     for k in sorted(opt.state[p])]


def ft_differ(torch, got, want):
    """(tensors that differ in any bit, max |d| over all)."""
    n, worst = 0, 0.0
    for a, b in zip(got, want):
        if not torch.equal(a, b):
            n += 1
            worst = max(worst, (a.float() - b.float()).abs().max().item())
    return n, worst


def adamw_capturable_check(torch, card):
    """`trainstep.adamw` on the card made capturable (`train_graph.
    capturable`, what a captured step does to its optimizer: bias
    corrections by tensor ops, step counts on the card) and as it is
    (`capturable=False`, Python floats) against optax's adamw in float64
    (numpy), FT_ADAMW_STEPS steps on fixed gradients of magnitudes
    1e-9..10 (eps matters at the small ones): each within FT_ADAMW_ATOL·lr,
    and how many elements the two torch versions differ in."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.parallel import trainstep as ts
    from toolbox_for_asr_and_tts_tpu_torch.runtime.train_graph import (
        capturable)
    rng = np.random.default_rng(5)
    n = 1 << 16
    p0 = (0.05 * rng.standard_normal(n)).astype(np.float32)
    grads = [(rng.standard_normal(n) * 10.0 ** rng.uniform(-9, 1, n)
              ).astype(np.float32) for _ in range(FT_ADAMW_STEPS)]
    hp = ts.ADAMW_DEFAULTS
    b1, b2 = hp["betas"]
    p, m, v = p0.astype(np.float64), np.zeros(n), np.zeros(n)
    for t, g in enumerate(grads, 1):
        g = g.astype(np.float64)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        u = (m / (1 - b1 ** t)) / (np.sqrt(v / (1 - b2 ** t)) + hp["eps"])
        p = p - FT_LR * (u + hp["weight_decay"] * p)
    out = {}
    for name, capture in (("capturable", True), ("plain", False)):
        w = torch.tensor(p0, device="cuda", requires_grad=True)
        opt = ts.adamw(FT_LR)([w])
        if capture:
            capturable(opt)
        require(bool(opt.param_groups[0]["capturable"]) is capture,
                f"adamw on the card: capturable {not capture}")
        for g in grads:
            w.grad = torch.tensor(g, device="cuda")
            opt.step()
        out[name] = w.detach().cpu().numpy()
    err = {k: float(np.abs(v_.astype(np.float64) - p).max()) / FT_LR
           for k, v_ in out.items()}
    bits = int((out["capturable"] != out["plain"]).sum())
    for k, e in err.items():
        require(e <= FT_ADAMW_ATOL, f"AdamW {k}: {e:.3g} lr from optax's "
                                    f"formula")
    print(f"AdamW on the card, {FT_ADAMW_STEPS} steps on {n} elements: "
          f"capturable {err['capturable']:.3g} lr and capturable=False "
          f"{err['plain']:.3g} lr from optax's adamw in float64 (tol "
          f"{FT_ADAMW_ATOL} lr); the two differ in {bits} elements, max "
          f"|d| {np.abs(out['capturable'] - out['plain']).max():.3g} "
          f"({card})", flush=True)
    return dict(steps=FT_ADAMW_STEPS, elements=n, tol_lr=FT_ADAMW_ATOL,
                capturable_err_lr=err["capturable"],
                plain_err_lr=err["plain"], elements_differing=bits)


def ft_sights(seq):
    """A captured step's calls over a sequence of batch shapes: (first
    sights: eager steps, second sights: eager step and capture, later
    sights: replays, distinct shapes)."""
    seen = {}
    for key in seq:
        seen[key] = seen.get(key, 0) + 1
    calls = list(seen.values())
    first = len(calls)
    second = sum(1 for n in calls if n >= 2)
    return first, second, len(seq) - first - second, first


def ft_frames(n: int, fe_cfg) -> int:
    """T_lfr of a batch whose longest row has n samples (`_features`')."""
    from toolbox_for_asr_and_tts_tpu_torch.ops import frontend as fe
    return fe.num_lfr_frames(fe.num_fbank_frames(n, fe_cfg), fe_cfg.lfr_n)


def ft_cli_shapes(items, fe_cfg, steps: int, batch: int):
    """T of each of the CLI's first `steps` batches: its draw
    (`finetune._draw` from `default_rng(0)`), padded to the longest row."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.tools import finetune
    rng = np.random.default_rng(0)
    return [ft_frames(max(len(w) for w, _ in finetune._draw(items, batch,
                                                            rng)), fe_cfg)
            for _ in range(steps)]


def ft_shape_share(cfg, eager_s: float, capture_s: float, replay_s: float):
    """The share of the CLI's steps at a new batch shape on a manifest of
    mixed lengths: FT_MIXED_ROWS rows of durations uniform over
    FT_MIXED_SECONDS (seed 17; host only: the draw and T, no audio), at
    each of FT_MIXED_BATCHES and FT_MIXED_STEPS. For each, the captured
    step's calls (first sights eager, second eager and capture, later
    replays) and the steps' seconds projected with this run's phase-10
    unit costs (8 rows, T 167): eager only, capture at a shape's first
    sight, and at its second, as `train_graph` does."""
    import numpy as np
    rng = np.random.default_rng(17)
    lo, hi = FT_MIXED_SECONDS
    items = [(np.empty(int(s * SR), np.float32), [4]) for s in
             rng.uniform(lo, hi, FT_MIXED_ROWS)]
    out = []
    for batch in FT_MIXED_BATCHES:
        seq = ft_cli_shapes(items, cfg.frontend, max(FT_MIXED_STEPS), batch)
        for steps in FT_MIXED_STEPS:
            first, second, later, distinct = ft_sights(seq[:steps])
            row = dict(
                batch=batch, steps=steps, distinct_T=distinct,
                new_shape_share=first / steps, eager=first, captures=second,
                replays=later,
                projected_s=dict(
                    eager=steps * eager_s,
                    capture_at_first=(first * (eager_s + capture_s)
                                      + (steps - first) * replay_s),
                    capture_at_second=(first * eager_s + second * (
                        eager_s + capture_s) + later * replay_s)))
            out.append(row)
            p = row["projected_s"]
            print(f"fine-tuning shapes, mixed lengths ({FT_MIXED_ROWS} rows "
                  f"uniform {lo}-{hi} s), batch {batch}, {steps} steps: "
                  f"{distinct} distinct T, {100 * first / steps:.1f}% of "
                  f"the steps at a new shape; {first} eager, {second} "
                  f"captures, {later} replays; projected at phase 10's unit "
                  f"costs: eager {p['eager']:.1f} s, capture at the first "
                  f"sight {p['capture_at_first']:.1f} s, at the second "
                  f"{p['capture_at_second']:.1f} s", flush=True)
    return dict(rows=FT_MIXED_ROWS, seconds=list(FT_MIXED_SECONDS),
                unit_s=dict(eager=eager_s, capture=capture_s,
                            replay=replay_s), runs=out)


def ft_captured(torch, card, cfg, items, ck):
    """Two fresh seed-0 trees whose AdamW is capturable (`train_graph.
    capturable`, as a captured step makes it): FT_STEPS eager steps on one,
    FT_STEPS calls of the captured step (`capture_train_step`) on the other
    on phase 10's fixed batch, the first the eager step, the second the
    eager step and its capture, the rest replays (K1 66, dw 66 each, K2 1
    per step from the features), saving at FT_RESUME_AT into `ck`. Losses,
    parameters and AdamW state bit-equal; walls, capture seconds, the
    pool; then the card's busy time over one captured step (a replay) and
    one eager step of the capturable optimizer. → (its line, the captured
    run's parameters and state)."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.parallel import trainstep as ts
    from toolbox_for_asr_and_tts_tpu_torch.runtime import train_ckpt as tc
    from toolbox_for_asr_and_tts_tpu_torch.runtime.train_graph import (
        capturable, capture_train_step)
    layers = cfg.encoder_layers + cfg.decoder_layers
    e_params, e_opt, e_step = ft_fresh(torch, cfg)
    capturable(e_opt)
    e_losses, e_walls, _, _ = ft_steps(torch, e_step, e_params, e_opt, items,
                                       cfg)
    params, opt, step = ft_fresh(torch, cfg)
    cstep = capture_train_step(step, params, opt)
    require(opt.param_groups[0]["capturable"], "the captured step's AdamW "
                                               "is not capturable")

    def save_at(i):
        if i == FT_RESUME_AT:
            tc.save_train_state(ck, i, params, opt)
    losses, walls, launches, _ = ft_steps(torch, cstep, params, opt, items,
                                          cfg, save_at)
    progs = cstep.programs
    prog = progs._progs[next(iter(progs))]
    require((len(progs), progs.captures, progs.replays, cstep.eager)
            == (1, 1, FT_STEPS - 2, 1),
            f"captured step: {cstep.stats()}, expected 1 eager step, 1 "
            f"capture and {FT_STEPS - 2} replays")
    require(prog.tally == {"fsmn_conv": layers, "fsmn_conv_dw": layers},
            f"captured step's tally {prog.tally}")
    for i, n in enumerate(launches):
        require(n == (layers, layers, 1), f"captured step {i}: K1 / dw / K2 "
                                          f"{n}, expected {(layers, layers, 1)}")
    require(all(p.grad is None for p in ts.param_leaves(params)),
            "a captured step left gradients behind")
    require(losses == e_losses, f"captured losses {losses} against eager "
                                f"{e_losses}")
    n_diff, worst = ft_differ(torch, ft_state(torch, params, opt),
                              ft_state(torch, e_params, e_opt))
    require(n_diff == 0, f"captured run against the eager one: {n_diff} "
                         f"tensors differ, max |d| {worst}")
    # the run's end, before the profile steps on
    want = [t.detach().clone() for t in ft_state(torch, params, opt)]
    shapes = {n: list(shape) for n, shape, _ in prog.key}
    replays = walls[2:]
    med, p95 = statistics.median(replays), float(np.percentile(replays, 95))
    e_med = statistics.median(e_walls)
    e_p95 = float(np.percentile(e_walls, 95))
    pool = progs.pool_bytes()
    print(f"fine-tuning captured: {FT_STEPS} steps (the first the eager "
          f"step at feats {shapes['feats']} / targets {shapes['targets']}, "
          f"{walls[0] * 1e3:.1f} ms, the second the eager step and its "
          f"capture, {walls[1] * 1e3:.1f} ms of which the capture "
          f"{progs.capture_s:.2f} s, then {progs.replays} replays): losses "
          f"and all {len(ft_state(torch, params, opt))} parameter and AdamW "
          f"state tensors bit-equal to {FT_STEPS} eager steps of the same "
          f"capturable AdamW, no gradient left behind; K1 / dw / K2 "
          f"{launches[2]} per replayed step, tally {prog.tally}; replay "
          f"step wall median {med * 1e3:.1f} ms, p95 {p95 * 1e3:.1f} ms "
          f"(eager, capturable AdamW: {e_med * 1e3:.1f} / {e_p95 * 1e3:.1f} "
          f"ms); graph pool {pool} bytes ({card})", flush=True)
    prof = profile_train_step(torch, cstep, params, opt, items, cfg,
                              med * 1e3, "captured")
    e_prof = profile_train_step(torch, e_step, e_params, e_opt, items, cfg,
                                e_med * 1e3, "eager capturable")
    return dict(
        steps=FT_STEPS, shapes=shapes,
        capture_s=progs.capture_s, first_call_ms=walls[0] * 1e3,
        capture_call_ms=walls[1] * 1e3,
        step_wall_ms_median=med * 1e3, step_wall_ms_p95=p95 * 1e3,
        step_wall_ms=[w * 1e3 for w in walls],
        eager_capturable_step_wall_ms_median=e_med * 1e3,
        eager_capturable_step_wall_ms_p95=e_p95 * 1e3,
        pool_bytes=pool, tally=dict(prog.tally),
        launches_per_step={"fsmn_conv": launches[2][0],
                           "fsmn_conv_dw": launches[2][1],
                           "frame_window": launches[2][2]},
        equal_to_eager=True, profile=prof,
        eager_capturable_profile=e_prof), want


def ft_captured_resume(torch, cfg, items, ck, want):
    """A fresh seed-0 tree whose captured step has captured (two calls at
    the batch's shape), restored from the captured run's save at
    FT_RESUME_AT: the parameters copied into their storages, the optimizer
    given the saved state, so the step drops its program; continued to
    FT_STEPS (an eager step, the step and its capture, replays): every
    parameter and state tensor bit-equal to `want` (the uninterrupted
    captured run's)."""
    from toolbox_for_asr_and_tts_tpu_torch.parallel import trainstep as ts
    from toolbox_for_asr_and_tts_tpu_torch.runtime import train_ckpt as tc
    from toolbox_for_asr_and_tts_tpu_torch.runtime.train_graph import (
        capture_train_step)
    from toolbox_for_asr_and_tts_tpu_torch.tools import finetune
    t0 = time.perf_counter()
    params, opt, step = ft_fresh(torch, cfg)
    cstep = capture_train_step(step, params, opt)

    def batch():
        return finetune._features(items, cfg.frontend, FT_K_MAX,
                                  torch.device("cuda"))
    for _ in range(2):
        cstep(params, opt, batch())
    require(cstep.programs.captures == 1, f"no capture before the restore: "
                                          f"{cstep.stats()}")
    ptrs = [p.data_ptr() for p in ts.param_leaves(params)]
    got = tc.restore_train_state(ck, params, opt)
    require(got is not None and got[0] == FT_RESUME_AT,
            f"restored {got and got[0]}, saved {FT_RESUME_AT}")
    require([p.data_ptr() for p in ts.param_leaves(params)] == ptrs,
            "a restore moved a parameter's storage")
    for _ in range(FT_RESUME_AT, FT_STEPS):
        cstep(params, opt, batch())
    torch.cuda.synchronize()
    stats = cstep.stats()
    want_calls = (2, 2, FT_STEPS - FT_RESUME_AT - 2)
    require((stats["eager"], stats["captures"], stats["replays"])
            == want_calls, f"captured resume: {stats}, expected eager / "
                           f"captures / replays {want_calls}")
    n_diff, worst = ft_differ(torch, ft_state(torch, params, opt), want)
    require(n_diff == 0, f"captured resume against the uninterrupted run: "
                         f"{n_diff} tensors differ, max |d| {worst}")
    seconds = time.perf_counter() - t0
    print(f"fine-tuning captured resume: a fresh tree captured at its "
          f"second step, restored from the captured run's step "
          f"{FT_RESUME_AT} (parameters in place, the optimizer's state "
          f"replaced, the program dropped), continued to {FT_STEPS}: "
          f"bit-equal to the uninterrupted run; eager / captures / replays "
          f"{want_calls} over both halves, {seconds:.1f} s", flush=True)
    return dict(equal=True, parameter_storages_kept=True,
                eager=stats["eager"], captures=stats["captures"],
                replays=stats["replays"], seconds=seconds)


def ft_remat(torch, cfg, items):
    """`cfg.remat=True` (each encoder layer under torch.utils.checkpoint,
    recomputed in the backward pass on autograd's thread) on two fresh
    seed-0 trees with capturable AdamW: FT_REMAT_STEPS eager steps against
    as many calls of the captured step (its third a replay): losses,
    parameters and state bit-equal, and the replay's tally equal to an
    eager step's launches."""
    import dataclasses
    from toolbox_for_asr_and_tts_tpu_torch.ops.kernels import fsmn_conv as k1
    from toolbox_for_asr_and_tts_tpu_torch.ops.kernels import (
        fsmn_conv_dw as kdw)
    from toolbox_for_asr_and_tts_tpu_torch.runtime.train_graph import (
        capturable, capture_train_step)
    from toolbox_for_asr_and_tts_tpu_torch.tools import finetune
    t0 = time.perf_counter()
    cfg_r = dataclasses.replace(cfg, remat=True)
    batch = finetune._features(items, cfg.frontend, FT_K_MAX,
                               torch.device("cuda"))
    runs = {}
    for name in ("eager", "captured"):
        params, opt, step = ft_fresh(torch, cfg_r)
        if name == "captured":
            step = capture_train_step(step, params, opt)
        else:
            capturable(opt)
        losses = []
        for _ in range(FT_REMAT_STEPS):
            torch.cuda.synchronize()
            a, b = k1.launches, kdw.launches
            losses.append(step(params, opt, batch)[2]["loss"].item())
            launched = (k1.launches - a, kdw.launches - b)
        runs[name] = (losses, ft_state(torch, params, opt), launched, step)
    (l_e, s_e, n_e, _), (l_c, s_c, n_c, cstep) = (runs["eager"],
                                                  runs["captured"])
    prog = cstep.programs._progs[next(iter(cstep.programs))]
    tally = (prog.tally.get("fsmn_conv"), prog.tally.get("fsmn_conv_dw"))
    require(cstep.programs.replays == FT_REMAT_STEPS - 2,
            f"remat captured step: {cstep.stats()}")
    require(n_c == n_e == tally, f"remat launches: eager {n_e}, replay "
                                 f"{n_c}, tally {tally}")
    require(l_c == l_e, f"remat losses captured {l_c} against eager {l_e}")
    n_diff, worst = ft_differ(torch, s_c, s_e)
    require(n_diff == 0, f"remat captured against eager: {n_diff} tensors "
                         f"differ, max |d| {worst}")
    seconds = time.perf_counter() - t0
    print(f"fine-tuning remat: {FT_REMAT_STEPS} steps captured (the third "
          f"a replay) bit-equal to {FT_REMAT_STEPS} eager steps (losses "
          f"{l_c}); K1 / dw {n_e} per step (the encoder's "
          f"{cfg.encoder_layers} recomputed), "
          f"the replay's tally the same; {seconds:.1f} s", flush=True)
    return dict(steps=FT_REMAT_STEPS, equal=True, launches_per_step=list(n_e),
                seconds=seconds)


def ft_sync_raises(torch, items):
    """A step that fetches its loss inside the captured function (a host
    sync) on a narrow tree: its first call is the eager step and passes;
    its second runs the eager step and the capture, which raises, saying
    that the step was applied; so does the third. The program stays
    without a graph, and nothing runs eagerly in a capture's place."""
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer import (
        ParaformerConfig)
    from toolbox_for_asr_and_tts_tpu_torch.runtime.train_graph import (
        capture_train_step)
    from toolbox_for_asr_and_tts_tpu_torch.tools import finetune
    cfg = ParaformerConfig(d_model=32, n_heads=2, ffn_dim=64,
                           encoder_layers=2, decoder_layers=1)
    params, opt, step = ft_fresh(torch, cfg)
    capturing = []

    def syncing(p, o, b):
        out = step(p, o, b)
        capturing.append(torch.cuda.is_current_stream_capturing())
        float(out[2]["loss"])
        return out
    cstep = capture_train_step(syncing, params, opt)
    batch = finetune._features(items[:2], cfg.frontend, FT_K_MAX,
                               torch.device("cuda"))
    cstep(params, opt, batch)
    errors, notes = [], []
    for _ in range(2):
        try:
            cstep(params, opt, batch)
        except Exception as e:   # the capture's failure, as raised
            errors.append(f"{type(e).__name__}: {str(e).splitlines()[0]}")
            notes.append(" ".join(getattr(e, "__notes__", [])))
        progs = cstep.programs
        require(len(progs) == 1 and all(progs._progs[k].graph is None
                                        for k in progs)
                and capturing[-1] is True,
                "a capture that syncs left a graph or did not capture")
    torch.cuda.synchronize()
    require(len(errors) == 2, "a step that syncs inside its capture did "
                              "not raise")
    require(all("advanced one step" in n for n in notes),
            f"the failed capture's error does not say the step ran: {notes}")
    print(f"fine-tuning capture that syncs: the first call's eager step "
          f"ran; the capture raised on both later calls, saying the step "
          f"was applied, no graph kept ({errors[0][:120]})", flush=True)
    return dict(raised=len(errors), error=errors[0], note=notes[0])


def finetune_path(torch, card, wavs, eager_only: bool = False):
    """Fine-tuning at full width (Paraformer-large, the 8 rows of
    `make_wavs` with random targets, k_max 32): card vs CPU gradients;
    FT_STEPS eager steps on one fixed batch (K1 66, dw 66, K2 1 per step; a
    finite loss that falls); a fresh seed-0 tree restored from the save at
    step FT_RESUME_AT continued to FT_STEPS equal to the uninterrupted run;
    the eager step's profile; the card's AdamW against optax's formula;
    the captured step (`ft_captured`: bit-equal to the eager run of the
    same capturable AdamW, its resume, its profile, `ft_remat`,
    `ft_sync_raises`); `tools/finetune.py` with `--export`, running
    captured, whose export served by `Recognizer.from_model_dir` gives the
    ids of a Recognizer on the CLI's tuned tree in memory; the share of
    the CLI's steps at a new shape on a mixed-length manifest. cuDNN runs
    deterministic here (the predictor conv's weight gradient), so a
    resumed run can equal the uninterrupted one bit for bit.

    eager_only: the eager steps, their resume and their profile alone,
    which a tree without `runtime/train_graph.py` also runs (so this
    script copied beside an older tree times that tree's eager step)."""
    import shutil
    import tempfile
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import Recognizer
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer import (
        ParaformerConfig)
    from toolbox_for_asr_and_tts_tpu_torch.parallel import trainstep as ts
    from toolbox_for_asr_and_tts_tpu_torch.runtime import train_ckpt as tc
    from toolbox_for_asr_and_tts_tpu_torch.tools import finetune
    cfg = ParaformerConfig()
    layers = cfg.encoder_layers + cfg.decoder_layers
    root = tempfile.mkdtemp(prefix="finetune-")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        reco = Recognizer.random(cfg, seed=0)
        manifest = ft_manifest(root, wavs, reco.tokenizer)
        items = finetune._load_manifest(manifest, reco.tokenizer,
                                        cfg.frontend, FT_K_MAX, 10.0)
        init_opt, step = ts.make_train_step(cfg, ts.adamw(FT_LR))
        params = reco.params
        opt = init_opt(params)
        vs_cpu = (None if eager_only
                  else ft_card_vs_cpu(torch, cfg, params, items))

        ck = os.path.join(root, "ck")
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()   # the earlier phases' too

        def save_at(i):
            if i == FT_RESUME_AT:
                t = time.perf_counter()
                tc.save_train_state(ck, i, params, opt)
                save_s.append(time.perf_counter() - t)
        save_s = []
        losses, walls, launches, batch = ft_steps(torch, step, params, opt,
                                                  items, cfg, save_at)
        peak = torch.cuda.max_memory_allocated()
        want = (layers, layers, 1)
        for i, n in enumerate(launches):
            require(n == want, f"fine-tuning step {i}: K1 / dw / K2 launched "
                               f"{n}, expected {want}")
        require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
        require(losses[-1] < losses[0], f"the loss did not fall over "
                                        f"{FT_STEPS} steps: {losses}")
        audio_s = sum(len(w) for w, _ in items) / SR
        tokens = int(batch["target_lens"].sum().item())
        med = statistics.median(walls)
        p95 = float(np.percentile(walls, 95))
        print(f"fine-tuning: {FT_STEPS} steps of 8 rows ({audio_s:.1f} s of "
              f"audio, {tokens} target tokens, k_max {FT_K_MAX}) on {card}: "
              f"step wall median {med * 1e3:.1f} ms, p95 {p95 * 1e3:.1f} ms "
              f"({audio_s / med:.1f} audio s/s, {tokens / med:.0f} tokens/s); "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({', '.join(f'{v:.3f}' for v in losses)}); launches per step "
              f"K1 {launches[0][0]}, dw {launches[0][1]}, K2 "
              f"{launches[0][2]}; peak allocated {peak / 2**30:.2f} GiB "
              f"({(peak - resident) / 2**30:.2f} GiB above the "
              f"{resident / 2**30:.2f} GiB resident before the steps)",
              flush=True)

        # resume: a fresh seed-0 tree and optimizer, restored, continued
        t = time.perf_counter()
        reco2 = Recognizer.random(cfg, seed=0)
        init2, step2 = ts.make_train_step(cfg, ts.adamw(FT_LR))
        opt2 = init2(reco2.params)
        got = tc.restore_train_state(ck, reco2.params, opt2)
        require(got is not None and got[0] == FT_RESUME_AT,
                f"restored {got and got[0]}, saved {FT_RESUME_AT}")
        restore_s = time.perf_counter() - t
        params2 = reco2.params
        for _ in range(FT_RESUME_AT, FT_STEPS):
            batch2 = finetune._features(items, cfg.frontend, FT_K_MAX,
                                        torch.device("cuda"))
            params2, opt2, _ = step2(params2, opt2, batch2)
        torch.cuda.synchronize()
        resume_d = max((a - b).abs().max().item() for a, b in
                       zip(ts.param_leaves(params), ts.param_leaves(params2)))
        scale = max(a.abs().max().item() for a in ts.param_leaves(params))
        require(resume_d <= 1e-6 + 1e-6 * scale,
                f"resumed run differs from the uninterrupted one by "
                f"{resume_d}")
        print(f"fine-tuning resume: saved at step {FT_RESUME_AT} "
              f"({save_s[0]:.1f} s), restored into a fresh tree "
              f"({restore_s:.1f} s), continued to step {FT_STEPS}: max |d| "
              f"against the uninterrupted run {resume_d:.3g}", flush=True)
        del reco2, params2, opt2
        prof = profile_train_step(torch, step, params, opt, items, cfg,
                                  med * 1e3)
        out = dict(
            config="ParaformerConfig()", rows=len(items), audio_s=audio_s,
            target_tokens=tokens, k_max=FT_K_MAX, lr=FT_LR, steps=FT_STEPS,
            step_wall_ms_median=med * 1e3, step_wall_ms_p95=p95 * 1e3,
            step_wall_ms=[w * 1e3 for w in walls],
            audio_s_per_s=audio_s / med, tokens_per_s=tokens / med,
            loss_first=losses[0], loss_last=losses[-1], losses=losses,
            max_memory_allocated=peak, memory_resident_before=resident,
            launches_per_step={"fsmn_conv": launches[0][0],
                               "fsmn_conv_dw": launches[0][1],
                               "frame_window": launches[0][2]},
            card_vs_cpu=vs_cpu, resume_max_abs_diff=resume_d,
            save_s=save_s[0], restore_s=restore_s, profile=prof)
        if eager_only:
            print(f"fine-tuning phase (eager only): "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            return out

        # the captured step (runtime/train_graph.py)
        adamw_check = adamw_capturable_check(torch, card)
        ck_captured = os.path.join(root, "ck-captured")
        captured, captured_end = ft_captured(torch, card, cfg, items,
                                             ck_captured)
        captured["resume"] = ft_captured_resume(torch, cfg, items,
                                                ck_captured, captured_end)
        del captured_end
        captured["remat"] = ft_remat(torch, cfg, items)
        captured["sync_raises"] = ft_sync_raises(torch, items)
        captured["mixed_lengths"] = ft_shape_share(
            cfg, med, captured["capture_s"],
            captured["step_wall_ms_median"] / 1e3)

        # the CLI with --export (its draws bring a T back twice, so it
        # captures and replays), then the export served
        seq = ft_cli_shapes(items, cfg.frontend, FT_CLI_STEPS, 8)
        cli_want = ft_sights(seq)[:3]
        require(cli_want[2] >= 1, f"the CLI's batches {seq} bring no T back "
                                  f"twice")
        t = time.perf_counter()
        mount = os.path.join(root, "mount")
        res = finetune.main(
            ["--manifest", manifest, "--ckpt-dir", os.path.join(root, "cli"),
             "--steps", str(FT_CLI_STEPS), "--batch", "8",
             "--save-every", str(FT_CLI_STEPS),
             "--k-max", str(FT_K_MAX), "--max-secs", "10",
             "--export", os.path.join(mount, "torch_params.npz")])
        cli_s = time.perf_counter() - t
        require(len(res["losses"]) == FT_CLI_STEPS
                and all(np.isfinite(res["losses"])),
                f"finetune CLI losses {res['losses']}")
        cli_graphs = res["train_graphs"]
        got_calls = (cli_graphs["eager"], cli_graphs["captures"],
                     cli_graphs["replays"])
        require(got_calls == cli_want, f"finetune CLI over T {seq}: eager / "
                                       f"captures / replays {got_calls}, "
                                       f"expected {cli_want}")
        served = Recognizer.from_model_dir(mount)
        tuned = Recognizer(res["params"], res["cfg"], res["tokenizer"])
        a, b = served.transcribe(wavs), tuned.transcribe(wavs)
        ids = [r.token_ids for r in a]
        require(ids == [r.token_ids for r in b], "the exported tree served "
                "other ids than the tuned tree in memory")
        print(f"fine-tuning CLI: {FT_CLI_STEPS} steps with --export in "
              f"{cli_s:.1f} s (losses {res['losses']}; batch T {seq}: "
              f"{cli_graphs['eager']} eager first steps, "
              f"{cli_graphs['captures']} captures, {cli_graphs['replays']} "
              f"replays); Recognizer.from_model_dir on the export: ids equal "
              f"to the tuned tree's in memory on all 8 rows "
              f"({sum(len(i) for i in ids)} tokens)", flush=True)
        print(f"fine-tuning phase: {time.perf_counter() - t0:.1f} s",
              flush=True)
        graph_snapshot("finetune")
        return dict(out, cli_s=cli_s, cli_losses=res["losses"],
                    cli_graphs=cli_graphs, cli_T=seq, export_ids_equal=True,
                    captured=captured, adamw=adamw_check)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(root, ignore_errors=True)
        _FT_TREES.clear()


# ---------------------------------------- phase 11: reduced precision
PRECISION_CALLS = 12        # timed transcribes per mode (median, p95)
INT8_STREAM_SIZES = (1, 64)  # S = 1: a chunked step of 9 rows, padded
INT8_COMPARE_TICKS = 3      # ticker ticks of fresh sessions beside the CPU's
INT8_COMPARE_STEPS = 4      # direct steps held against the CPU
ENCODER_LINEARS = ("attn.qkv", "attn.out", "ffn.w1", "ffn.w2")
# _linear_int8 at the offline encoder's shapes: 8 rows x 167 LFR frames
INT8_SHAPES = (("qkv", 512, 1536), ("out", 512, 512), ("w1", 512, 2048),
               ("w2", 2048, 512))
INT8_ROWS = 8 * 167
# cuBLASLt's int8 GEMM kernels by name (s8 / i8 operands, IMMA, i8 WMMA)
INT8_GEMM = re.compile(r"s8|i8|imma|i161616", re.IGNORECASE)


def tree_bytes(torch, tree) -> int:
    return sum(t.numel() * t.element_size() for t in _flat(torch, tree))


def profiled(torch, fn):
    """fn under torch.profiler (host and card): (its result, the profile)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, prof


def op_calls(prof, name: str) -> int:
    """Host calls of one aten operator in a profile."""
    return sum(e.count for e in prof.key_averages() if e.key == name)


def precision_mode(torch, card, mode: str, reco, wavs, compare=None):
    """One Recognizer of phase 11 (`mode`: f32, bf16 or int8) on the card:
    K1 66 / K2 1 per transcribe, its forward's replay bit-equal to its
    eager call, `compare(reco)` (card vs the same tree on the CPU); the
    transcribe wall over PRECISION_CALLS calls, the card's busy time of
    one (torch.profiler), the weights' and the graph pool's bytes."""
    cfg = reco.cfg
    reco.transcribe(wavs)                      # capture, plans
    res, k1_n, k2_n = counted(torch, lambda: reco.transcribe(wavs))
    check_results(res, wavs, cfg)
    layers = cfg.encoder_layers + cfg.decoder_layers
    require(k1_n == layers and k2_n == 1,
            f"{mode}: K1 {k1_n} (want {layers}), K2 {k2_n} (want 1) per "
            f"transcribe")
    batch, lens = reco.bucketer.pad_batch(wavs)
    n_out = replay_vs_eager(torch, reco._fn_for(*batch.shape), batch, lens,
                            what=f"{mode} recognizer forward")
    vs_cpu = compare(reco) if compare is not None else None
    walls = []
    for _ in range(PRECISION_CALLS):
        t0 = time.perf_counter()
        reco.transcribe(wavs)
        walls.append(time.perf_counter() - t0)
    wall = quantiles(walls)
    _, prof = profiled(torch, lambda: reco.transcribe(wavs))
    rows = _device_events(prof)
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    require(busy > 0, f"{mode}: the profiler saw no device time")
    out = dict(weight_bytes=tree_bytes(torch, reco.params),
               k1_per_transcribe=k1_n, k2_per_transcribe=k2_n,
               replay_outputs=n_out, wall=wall, busy_ms=busy,
               idle_share=1 - busy / wall["median_ms"],
               kernels_per_transcribe=sum(e.count for e in rows),
               pool_bytes=reco._programs.pool_bytes(),
               ids=[r.token_ids for r in res], card_vs_cpu=vs_cpu)
    print(f"precision {mode}: weights {out['weight_bytes'] / 1e6:.1f} MB; "
          f"K1 {k1_n}, K2 {k2_n} per transcribe; replay = eager "
          f"({n_out} outputs); transcribe wall median "
          f"{wall['median_ms']:.2f} ms, p95 {wall['p95_ms']:.2f} ms over "
          f"{wall['n']}; card busy {busy:.2f} ms (idle "
          f"{100 * out['idle_share']:.1f} %, {out['kernels_per_transcribe']} "
          f"kernels); graph pool "
          f"{(out['pool_bytes'] or 0) / 1e6:.1f} MB on {card}", flush=True)
    return out, prof


def compare_int8(torch, reco, cpu, ref, wavs):
    """The W8A8 forward on the card vs the same quantized tree on the CPU
    (`cpu`), rows CPU_ROWS, held to the quantization's own error q: the
    CPU int8 run's max |dlogit| against the f32 forward (`ref`, phase 3's
    tree on the card). Token counts equal, max |dlogit| card vs CPU <= q,
    tokens equal wherever the CPU's top-2 gap exceeds q. Phase 3's 1e-3
    rule does not hold under int8: where the two devices' f32 sums put an
    activation at a half step, its code rounds the other way, which moves
    the product by one int8 step, and 50 layers carry it on."""
    import numpy as np
    batch, lens = reco.bucketer.pad_batch([wavs[i] for i in CPU_ROWS])
    a, f = ({k: v.cpu() for k, v in r.forward_padded(batch, lens).items()}
            for r in (reco, ref))
    b = cpu.forward_padded(batch, lens)
    count = b["token_count"].numpy()
    require((a["token_count"].numpy() == count).all(),
            f"int8 token_count card {a['token_count'].tolist()} cpu "
            f"{count.tolist()}")
    logits = b["logits"].double().numpy()
    valid = np.arange(logits.shape[1])[None] < count[:, None]
    q = float(np.abs(logits - f["logits"].double().numpy())[valid].max())
    d = float(np.abs(a["logits"].double().numpy() - logits)[valid].max())
    top2 = np.sort(logits, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    same = a["tokens"].numpy() == b["tokens"].numpy()
    differ = valid & ~same
    row = dict(rows=list(CPU_ROWS), token_count=count.tolist(),
               tokens_equal=int((valid & same).sum()),
               tokens_differ=int(differ.sum()),
               differing_gaps=[float(g) for g in gap[differ]],
               max_abs_dlogit=d, quantization_max_abs_dlogit=q,
               max_abs_logit=float(np.abs(logits).max()),
               f32_tokens_equal=int((valid & (f["tokens"].numpy()
                                              == b["tokens"].numpy())).sum()))
    print(f"int8 card vs cpu: token_count {count.tolist()} equal; tokens "
          f"equal {row['tokens_equal']}/{int(valid.sum())}, "
          f"{row['tokens_differ']} differ (top-2 gaps "
          f"{[round(g, 5) for g in row['differing_gaps']]}); max|dlogit| "
          f"{d:.4g} against the quantization's own {q:.4g} (CPU int8 vs "
          f"f32; f32 and int8 ids equal at {row['f32_tokens_equal']}); "
          f"max|logit| {row['max_abs_logit']:.3g}", flush=True)
    require(d <= q, f"int8 logits differ card vs CPU by {d} > q {q}")
    require(not (differ & (gap > q)).any(),
            f"int8 tokens differ where the CPU's top-2 gap exceeds q {q}")
    return row


def int8_products(torch, reco, ref, wavs, prof):
    """The 200 int8 GEMMs of a W8A8 transcribe: an eager forward calls
    `torch._int_mm` once per quantized linear (4 per encoder layer) and
    `aten::mm` that many times fewer than the bf16 forward (`ref`); one
    replayed transcribe (`prof`) launches as many int8 GEMM kernels
    (INT8_GEMM) among the kernels that the bf16 replay does not run."""
    cfg = reco.cfg
    want = len(ENCODER_LINEARS) * cfg.encoder_layers
    batch, lens = reco.bucketer.pad_batch(wavs)
    calls = {}
    for name, r in (("int8", reco), ("bf16", ref)):
        _, p = profiled(torch, lambda: r.forward_padded(batch, lens))
        calls[name] = (op_calls(p, "aten::_int_mm"), op_calls(p, "aten::mm"))
    require(calls["int8"][0] == want and calls["bf16"][0] == 0,
            f"_int_mm calls per forward {calls}: want {want} under int8")
    require(calls["bf16"][1] - calls["int8"][1] == want,
            f"aten::mm calls per forward {calls}: the int8 forward should "
            f"run {want} fewer")
    # the replayed transcribe's kernels that the bf16 replay does not run:
    # the quantize / dequantize passes and cuBLASLt's int8 GEMMs, told
    # apart by the s8 / i8 / imma in their names
    _, pb = profiled(torch, lambda: ref.transcribe(wavs))
    seen = {e.key for e in _device_events(pb)}
    extra = {e.key: e.count for e in _device_events(prof)
             if e.key not in seen}
    gemm = {k: n for k, n in extra.items() if INT8_GEMM.search(k)}
    in_replay = sum(gemm.values())
    print(f"int8 GEMMs: {calls['int8'][0]} _int_mm per eager forward "
          f"(aten::mm {calls['int8'][1]} vs {calls['bf16'][1]} under bf16); "
          f"the replayed transcribe's kernels that bf16 does not run: "
          + "; ".join(f"{n} x {k[:110]}" for k, n in sorted(
              extra.items(), key=lambda kv: -kv[1])), flush=True)
    require(in_replay == want, f"{in_replay} int8 GEMM kernels in the "
                               f"replay ({sorted(gemm)}), {want} expected")
    return dict(int_mm_per_forward=calls["int8"][0],
                mm_per_forward={"int8": calls["int8"][1],
                                "bf16": calls["bf16"][1]},
                int8_gemm_kernels_in_replay=in_replay,
                int8_gemm_kernel_names=sorted(gemm))


def time_linear_int8(torch, card, peaks):
    """`_linear_int8` (quantize, `_int_mm`, dequantize) against the f32
    `dot` (TF32 off) at the encoder's shapes, with the int8 tensor-core and
    the f32 bounds; the card's result bit-equal to the CPU's, at the
    path's rows and at 9 (a chunked step's, padded to 17)."""
    from toolbox_for_asr_and_tts_tpu_torch.ops import nn
    out = []
    g = torch.Generator().manual_seed(11)
    for name, k, n in INT8_SHAPES:
        p = {"w": torch.randn(k, n, generator=g) * k ** -0.5,
             "b": torch.randn(n, generator=g) * 0.1}
        q = nn.quantize_linear_int8(p)
        pc = {a: v.cuda() for a, v in p.items()}
        qc = nn.quantize_linear_int8(pc)
        for a in q:
            require(torch.equal(qc[a].cpu(), q[a]),
                    f"{name}: quantized {a} differs card vs CPU")
        for rows in (INT8_ROWS, 9):
            x = torch.randn(rows, k, generator=g)
            got = nn.linear(qc, x.cuda()).cpu()
            require(torch.equal(got, nn.linear(q, x)),
                    f"{name} at {rows} rows: _linear_int8 card != CPU")
        x = torch.randn(INT8_ROWS, k, generator=g).cuda()
        ms_int8 = device_ms(torch, lambda: nn.linear(qc, x))
        ms_f32 = device_ms(torch, lambda: nn.linear(pc, x))
        xq = torch.randint(-127, 128, (INT8_ROWS, k), dtype=torch.int8,
                           device="cuda")
        ms_mm = device_ms(torch, lambda: torch._int_mm(xq, qc["w"]))
        ops = 2 * INT8_ROWS * k * n
        b_int8 = INT8_ROWS * k * 4 + k * n + 2 * n * 4 + INT8_ROWS * n * 4
        bound_int8 = max(b_int8 / peaks[0], ops / peaks[2]) * 1e3
        b_f32 = INT8_ROWS * k * 4 + k * n * 4 + n * 4 + INT8_ROWS * n * 4
        bound_f32, by_f32 = bound(b_f32, ops, peaks)
        row = dict(linear=name, shape=[INT8_ROWS, k, n], int8_ms=ms_int8,
                   int_mm_ms=ms_mm, f32_dot_ms=ms_f32,
                   int8_bound_ms=bound_int8,
                   int8_bound_by=("bytes" if b_int8 / peaks[0]
                                  >= ops / peaks[2] else "operations"),
                   f32_bound_ms=bound_f32, f32_bound_by=by_f32,
                   card_equals_cpu=True)
        out.append(row)
        print(f"_linear_int8 [{INT8_ROWS},{k}]x[{k},{n}] ({name}): "
              f"{ms_int8 * 1e3:.2f} us (the _int_mm alone "
              f"{ms_mm * 1e3:.2f} us; int8 bound {bound_int8 * 1e3:.2f} us "
              f"by {row['int8_bound_by']}) vs f32 dot {ms_f32 * 1e3:.2f} us "
              f"(f32 bound {bound_f32 * 1e3:.2f} us by {by_f32}); card = "
              f"CPU bit for bit at {INT8_ROWS} and 9 rows, on {card}",
              flush=True)
    return out


def first_ticks(asr, audios, n_ticks: int):
    """Per tick, each fresh session's partial ids over the first n_ticks
    0.4 s chunks; the sessions leave after."""
    slots = [asr.join() for _ in audios]
    out = []
    for c in range(n_ticks):
        fired = asr.tick({s: a[c * CHUNK:(c + 1) * CHUNK]
                          for s, a in zip(slots, audios)})
        out.append([list(fired.get(s, [])) for s in slots])
    for s in slots:
        asr.leave(s)
    return out


def direct_steps(torch, device, params, audios, n_steps: int):
    """The ticker step's halves (`fused_encode`, `fused_decode`) for the
    sessions as one batch on `device`, n_steps steps of 0.24 s from a
    fresh state: per step the fired counts, logits, token mask and the
    CIF's integrated mass (a token fires at each whole unit)."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.models import paraformer_online as po
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer import ParaformerConfig
    cfg, ocfg = ParaformerConfig(), po.OnlineConfig()
    a = ocfg.c1 * cfg.frontend.lfr_n * cfg.frontend.frame_shift
    audio = np.zeros((len(audios), n_steps * a), np.float32)
    for i, x in enumerate(audios):
        audio[i, :min(len(x), n_steps * a)] = x[:n_steps * a]
    out = []
    with torch.inference_mode():
        st = po.init_fused_state(cfg, ocfg, len(audios), True, device)
        for k in range(n_steps):
            chunk = torch.from_numpy(audio[:, k * a:(k + 1) * a]).to(device)
            st, enc, emb, n = po.fused_encode(params, st, chunk, cfg, ocfg,
                                              k_cap=ocfg.tokens_per_chunk)
            st, logits, mask = po.fused_decode(params, st, enc, emb, n, cfg,
                                               ocfg)
            out.append((n.cpu(), logits.double().cpu().numpy(),
                        mask.bool().cpu().numpy(),
                        st["cif_mass"].double().cpu().numpy()))
    return out


def direct_compare(got, want):
    """Two runs of `direct_steps` over the same sessions, session by
    session up to the first step whose fired count differs (CIF's state
    differs from there on): (per parted session the distance of `want`'s
    integrated mass from a whole unit at that step, the largest |dmass|
    before any parting, per kept step (logits, `want`'s logits, token
    mask) of the agreeing rows)."""
    import numpy as np
    live = np.ones(got[0][0].shape[0], bool)
    parted, dmass, kept = [], 0.0, []
    for (na, la, _, ma), (nb, lb, mb, mw) in zip(got, want):
        now = live & (na == nb).numpy()
        parted += [float(abs(mw[r] - np.round(mw[r])))
                   for r in np.flatnonzero(live & ~now)]
        live = now
        if live.any():
            dmass = max(dmass, float(np.abs(ma - mw)[live].max()))
        kept.append((la[live], lb[live], mb[live]))
    return parted, dmass, kept


def int8_streaming(torch, card, params, cpu_params, f32_params):
    """The quantized tree on the streaming path at S = 1 (a step of 9
    window rows: `_int_mm`'s padded path) and S = 64. Card vs CPU through
    the ticker step's halves for INT8_COMPARE_STEPS steps (`direct_steps`,
    `direct_compare`), held to the quantization's own error, as
    `compare_int8`: no more sessions whose fired counts part card vs CPU
    (its error: q the CPU int8 run's max |dlogit| against f32, δ its max
    |dmass| of CIF's integrated mass): a session's fired counts part card
    vs CPU only where the CPU's mass lies within δ of a whole unit (a
    firing threshold); up to that step, logits within q and ids equal
    where the CPU's top-2 gap exceeds q; at S = 1 every id equal. `BatchedChunkedASR(capacity=64,
    partials=True)`'s first INT8_COMPARE_TICKS ticks beside a CPU
    ticker's (agreement printed); a full drive with K1 50 / K2 1 per
    step, the step wall, and the step's replay bit-equal to its eager
    call."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer import ParaformerConfig
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer_online import OnlineConfig
    from toolbox_for_asr_and_tts_tpu_torch.parallel.stream_batcher import (
        BatchedChunkedASR)
    cfg, ocfg = ParaformerConfig(), OnlineConfig()
    cuda, cpu_dev = torch.device("cuda"), torch.device("cpu")
    out = {}
    for n in INT8_STREAM_SIZES:
        audios = session_audio(n, seed=300 + n)
        t0 = time.perf_counter()
        card_s, cpu_s, f32_s = (
            direct_steps(torch, dev, p, audios, INT8_COMPARE_STEPS)
            for dev, p in ((cuda, params), (cpu_dev, cpu_params),
                           (cuda, f32_params)))
        _, delta, kept_q = direct_compare(cpu_s, f32_s)
        parted, _, kept = direct_compare(card_s, cpu_s)
        q = max((float(np.abs(lb - lf)[mb].max()) for lb, lf, mb in kept_q
                 if mb.any()), default=0.0)
        d, equal, differ, gaps, min_gap = 0.0, 0, 0, [], float("inf")
        for la, lb, mb in kept:
            if not mb.any():
                continue
            d = max(d, float(np.abs(la - lb)[mb].max()))
            top2 = np.sort(lb, axis=-1)[..., -2:]
            gap = top2[..., 1] - top2[..., 0]
            eq = la.argmax(-1) == lb.argmax(-1)
            equal += int((mb & eq).sum())
            differ += int((mb & ~eq).sum())
            gaps += [float(g) for g in gap[mb & ~eq]]
            min_gap = min(min_gap, float(gap[mb].min()))
        direct = dict(steps=INT8_COMPARE_STEPS, sessions_parted=len(parted),
                      parted_mass_from_unit=parted,
                      quantization_max_abs_dmass=delta, ids_equal=equal,
                      ids_differ=differ, differing_gaps=gaps,
                      min_gap=min_gap, max_abs_dlogit=d,
                      quantization_max_abs_dlogit=q)
        print(f"int8 streaming S={n}: card vs CPU over {INT8_COMPARE_STEPS} "
              f"direct steps: {len(parted)} sessions' fired counts parted, "
              f"the CPU's mass {[round(m, 6) for m in parted]} from a whole "
              f"unit there (the quantization's max |dmass| {delta:.4g}); ids "
              f"equal {equal}, differ "
              f"{differ} (top-2 gaps {[round(g, 5) for g in gaps]}; least "
              f"gap {min_gap:.4g}); max|dlogit| {d:.4g} against the "
              f"quantization's {q:.4g}", flush=True)
        require(all(m <= delta for m in parted),
                f"int8 S={n}: fired counts part card vs CPU with the CPU's "
                f"mass {parted} from a whole unit, beyond {delta}")
        require(d <= q, f"int8 S={n}: logits differ card vs CPU by {d} > "
                        f"q {q}")
        require(not any(g > q for g in gaps),
                f"int8 S={n}: ids differ where the CPU's top-2 gap exceeds "
                f"q {q}: {gaps}")
        require(equal > 0, f"int8 S={n}: no token fired")
        if n == 1:
            require(differ == 0 and not parted,
                    "int8 S=1 (the padded path): ids differ card vs CPU")
        asr = BatchedChunkedASR(params, cfg, ocfg, capacity=64,
                                partials=True)
        cpu = BatchedChunkedASR(cpu_params, cfg, ocfg, capacity=64,
                                partials=True, device="cpu")
        got = first_ticks(asr, audios, INT8_COMPARE_TICKS)
        want = first_ticks(cpu, audios, INT8_COMPARE_TICKS)
        same = sum(g == w for tg, tw in zip(got, want)
                   for g, w in zip(tg, tw))
        cmp_s = time.perf_counter() - t0
        steps_before = asr.steps
        (ticks, ids, finals), k1_n, k2_n = counted(
            torch, lambda: drive_chunked(asr, audios))
        n_steps = asr.steps - steps_before
        require(k1_n == cfg.encoder_layers * n_steps and k2_n == n_steps,
                f"int8 S={n}: K1 {k1_n}, K2 {k2_n} in {n_steps} steps")
        every, _ = step_stats(ticks)
        tokens = sum(len(v) for v in ids.values())
        require(tokens > 0, f"int8 S={n}: no token fired")
        rng = np.random.default_rng(8)
        replay = replay_vs_eager(
            torch, asr._tick_fn(n),
            (0.1 * rng.standard_normal((n, asr.chunk_samples))).astype(
                np.float32), np.ones((n,), np.float32),
            what=f"int8 chunked step b{n}", state=list(asr.state.values()))
        out[f"S{n}"] = dict(
            sessions=n, steps=n_steps, k1_per_step=k1_n / n_steps,
            k2_per_step=k2_n / n_steps, step=every, tokens=tokens,
            replay_outputs=replay, direct=direct,
            ticker=dict(ticks=INT8_COMPARE_TICKS,
                        session_ticks=n * INT8_COMPARE_TICKS,
                        session_ticks_equal=same),
            compare_s=cmp_s)
        print(f"int8 streaming S={n}: ticker ids equal the CPU ticker's in "
              f"{same} of {n * INT8_COMPARE_TICKS} session-ticks; the step's "
              f"replay = eager ({replay} outputs and state leaves); {n_steps} "
              f"steps, K1 {k1_n / n_steps:g}/step, K2 {k2_n / n_steps:g}/"
              f"step; step wall median {every['median_ms']:.2f} ms, p95 "
              f"{every['p95_ms']:.2f} ms; {tokens} tokens, on {card}",
              flush=True)
    return out


def tts_bf16(torch, card, synth_f32):
    """`Synthesizer.random(seed=0, tiny=False, param_dtype=bfloat16)` on
    phase 7's paragraph: the RTF (median of 3 after a warm-up), the port's
    `mel_distance` on the card between its audio and phase 7's f32 audio
    (the same draw), and its first segment's PCM on the card within
    TTS_PCM_LSB of the same bf16 trees copied to the CPU."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.tools.mel_distance import mel_distance
    from toolbox_for_asr_and_tts_tpu_torch.tts.synthesizer import Synthesizer
    synth = tts_pin(Synthesizer.random(seed=0, tiny=False,
                                       param_dtype=torch.bfloat16))
    leaves = _flat(torch, synth.ap) + _flat(torch, synth.vp)
    require(all(t.dtype == torch.bfloat16 for t in leaves
                if t.is_floating_point()), "a floating leaf is not bf16")
    segments = tts_segments(synth)
    res = synth.synthesize(TTS_TEXT)           # captures, plans
    check_tts(synth, res, segments)
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        res, n = tts_counted(torch, synth, lambda: synth.synthesize(TTS_TEXT))
        runs.append(time.perf_counter() - t0)
        require(n["k1"] == 0 and n["k2"] == 0, "the TTS path launched K1/K2")
    wall = statistics.median(runs)
    audio_s = len(res.wav) / SR
    ref = tts_pin(synth_f32).synthesize(TTS_TEXT).wav
    dist = mel_distance(res.wav, ref)            # on the card
    cpu = tts_pin(Synthesizer(synth.ap, synth.acfg, synth.vp, synth.vcfg,
                              device="cpu"))
    (w_card, _), (w_cpu, _) = (s.synthesize_segments(segments[:1],
                                                     "zhitian_emo")
                               for s in (synth, cpu))
    require(len(w_card[0]) == len(w_cpu[0]),
            "first segment's length differs card vs CPU")
    lsb = int(np.abs(pcm16(w_card[0]) - pcm16(w_cpu[0])).max())
    require(lsb <= TTS_PCM_LSB, f"bf16 PCM differs by {lsb} LSB card vs CPU")
    out = dict(weight_bytes=tree_bytes(torch, synth.ap)
               + tree_bytes(torch, synth.vp),
               weight_bytes_f32=tree_bytes(torch, synth_f32.ap)
               + tree_bytes(torch, synth_f32.vp),
               wall_ms=wall * 1e3, audio_s=audio_s, rtf=wall / audio_s,
               mel_distance_vs_f32=dist, card_vs_cpu_pcm_max_lsb=lsb,
               card_vs_cpu_samples=len(w_card[0]),
               pool_bytes=synth.programs.pool_bytes())
    print(f"tts bf16: weights {out['weight_bytes'] / 1e6:.1f} MB (f32 "
          f"{out['weight_bytes_f32'] / 1e6:.1f} MB); synthesize "
          f"{audio_s:.2f} s of audio in {wall * 1e3:.1f} ms (median of 3), "
          f"RTF {out['rtf']:.5f}; mel distance to the f32 audio on the "
          f"card: rmse {dist['rmse_db']:.4f} dB, corr {dist['corr']:.6f} "
          f"over {dist['frames']} frames; first segment card vs CPU max "
          f"|d| {lsb} LSB (limit {TTS_PCM_LSB}) over {len(w_card[0])} "
          f"samples, on {card}", flush=True)
    return out


TRACE_TRANSCRIBES = 3


def trace_check(torch, reco, wavs):
    """TRACE_TRANSCRIBES bf16 transcribes under `runtime/profiling.
    trace_to`: the trace file exists, names the annotation and holds kernel
    events of both kernels; the kernel events it recorded are printed
    beside the launches the counters saw; `device_memory_stats()`. The
    profiler has been seen to drop the lone K2 event of a single traced
    transcribe late in a long process, so more than one is traced."""
    import shutil
    import tempfile
    from toolbox_for_asr_and_tts_tpu_torch.runtime import profiling
    root = tempfile.mkdtemp(prefix="trace-")

    def traced():
        with profiling.trace_to(root) as path:
            with profiling.annotate("precision-transcribe"):
                for _ in range(TRACE_TRANSCRIBES):
                    reco.transcribe(wavs)
        return path

    try:
        path, k1_n, k2_n = counted(torch, traced)
        require(os.path.exists(path), "trace_to wrote no file")
        size = os.path.getsize(path)
        with open(path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    seen = {name: sum(sym in e.get("name", "") for e in kernels)
            for name, sym in (("fsmn_conv", "fsmn_conv_kernel"),
                              ("frame_window", "frame_window_kernel"))}
    annotated = any(e.get("name") == "precision-transcribe" for e in events)
    print(f"trace_to: {size} bytes over {TRACE_TRANSCRIBES} transcribes, "
          f"{len(kernels)} kernel events: fsmn_conv {seen['fsmn_conv']} of "
          f"{k1_n} launches, frame_window {seen['frame_window']} of {k2_n}; "
          f"annotation {'named' if annotated else 'missing'}", flush=True)
    if not all(seen.values()):
        kernels.sort(key=lambda e: e.get("ts", 0))
        print("trace_to: the first kernel events: " + "; ".join(
            e.get("name", "")[:60] for e in kernels[:12]), flush=True)
    require(all(seen.values()) and annotated,
            f"the trace names {seen}, annotation {annotated}")
    stats = profiling.device_memory_stats()
    print(f"device_memory_stats() {stats}", flush=True)
    return dict(trace_bytes=size, kernel_events=seen,
                launches={"fsmn_conv": k1_n, "frame_window": k2_n},
                device_memory_stats=stats)


def precision_path(torch, card, peaks, reco_f32, wavs, synth_f32):
    """Phase 11: reduced-precision serving at full width on the card:
    Paraformer-large at param_dtype bf16 and under PARAFORMER_QUANT=int8
    beside phase 3's f32 recognizer (one card, one call), the int8
    chunked ticker, the bf16 Synthesizer, the int8 product's kernel times,
    a trace."""
    from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import Recognizer
    from toolbox_for_asr_and_tts_tpu_torch.tools.wer import corpus_cer
    t_phase = time.perf_counter()
    cfg = reco_f32.cfg
    out = {"linear_int8": time_linear_int8(torch, card, peaks)}
    out["f32"], _ = precision_mode(torch, card, "f32", reco_f32, wavs)
    bf16 = Recognizer.random(cfg, seed=0, param_dtype=torch.bfloat16)
    leaves = _flat(torch, bf16.params)
    require(all(t.dtype == torch.bfloat16 for t in leaves),
            "a leaf of the bf16 tree is not bf16")
    cpu_bf16 = Recognizer.random(cfg, seed=0, device="cpu",
                                 param_dtype=torch.bfloat16)
    out["bf16"], _ = precision_mode(
        torch, card, "bf16", bf16, wavs,
        lambda r: compare_cpu(torch, r, wavs, cpu=cpu_bf16,
                              what="bf16 card vs cpu"))
    del cpu_bf16
    prev = os.environ.get("PARAFORMER_QUANT")
    os.environ["PARAFORMER_QUANT"] = "int8"
    try:
        int8 = Recognizer.random(cfg, seed=0)
        cpu_int8 = Recognizer.random(cfg, seed=0, device="cpu")
    finally:
        if prev is None:
            del os.environ["PARAFORMER_QUANT"]
        else:
            os.environ["PARAFORMER_QUANT"] = prev
    n_int8 = sum(t.dtype == torch.int8 for t in _flat(torch, int8.params))
    require(n_int8 == len(ENCODER_LINEARS) * cfg.encoder_layers,
            f"{n_int8} int8 leaves in the quantized tree")
    q_equal = all(torch.equal(a.cpu(), b) for a, b in
                  zip(_flat(torch, int8.params), _flat(torch,
                                                       cpu_int8.params)))
    require(q_equal, "the card's quantized tree differs from the CPU's")
    out["int8"], prof = precision_mode(
        torch, card, "int8", int8, wavs,
        lambda r: compare_int8(torch, r, cpu_int8, reco_f32, wavs))
    out["int8"]["leaves_equal_cpu"] = q_equal
    out["int8"].update(int8_products(torch, int8, bf16, wavs, prof))
    tok = reco_f32.tokenizer
    pairs = [(tok.ids_to_text(a), tok.ids_to_text(b))
             for a, b in zip(out["f32"]["ids"], out["int8"]["ids"])]
    out["int8"]["cer_vs_f32"] = corpus_cer(pairs)
    out["bf16"]["cer_vs_f32"] = corpus_cer(
        [(tok.ids_to_text(a), tok.ids_to_text(b))
         for a, b in zip(out["f32"]["ids"], out["bf16"]["ids"])])
    print(f"CER against the f32 ids (random weights: printed, not gated): "
          f"int8 {out['int8']['cer_vs_f32']}, bf16 "
          f"{out['bf16']['cer_vs_f32']}", flush=True)
    out["int8_streaming"] = int8_streaming(torch, card, int8.params,
                                           cpu_int8.params, reco_f32.params)
    del cpu_int8
    out["tts_bf16"] = tts_bf16(torch, card, synth_f32)
    out["trace"] = trace_check(torch, bf16, wavs)
    for m in ("f32", "bf16", "int8"):
        out[m].pop("ids")
    graph_snapshot("precision")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"precision phase: {out['phase_s']:.1f} s", flush=True)
    return out

# ---------------------------- phase 12: dispatch profile and rehearsal
SWEEP_CAPACITIES = (64, 128, 192, 256)   # hub rows; every row a live session
SWEEP_TICKS = 8           # 0.4 s chunks fed to every session (3.2 s: all
                          # sessions are at least this long)
SWEEP_ROUNDS = 4          # C ascending, descending, ascending, descending
SWEEP_P95_MS = 100.0      # a capacity qualifies while its step p95 stays under
NEAR_BEST = 0.10          # within this share of the best ratio, the smallest C
KNOB_SAVING = 0.05        # a knob goes on only if it saves this share of wall
INT16_CALLS = 7           # timed transcribes per upload mode (median)
TTS_GROUP_CALLS = 5       # timed synthesize calls per grouping (median)


def probe_profile(torch, card):
    """The dispatch probe (`measure_rtt_ms`, median of 7) and the profile
    `get_profile()` resolved on the card, which must be `local`."""
    from toolbox_for_asr_and_tts_tpu_torch.runtime import autotune as at
    rtt = at.measure_rtt_ms(7)
    prof = at.get_profile()
    knobs = {k: prof[k] for k in at.profile_knobs("local", "cuda")}
    print(f"dispatch probe: a tiny op on the card and its .item() "
          f"{rtt * 1e3:.1f} us (median of 7); the profile resolved at start-"
          f"up: {prof['name']} on {prof['platform']} (probe "
          f"{prof['rtt_ms'] * 1e3:.1f} us, tunnel above "
          f"{at.TUNNEL_RTT_MS} ms), knobs {knobs} on {card}", flush=True)
    require(prof["name"] == "local" and prof["platform"] == "cuda",
            f"the card's profile resolved as {prof['name']} on "
            f"{prof['platform']}")
    require(knobs == at.profile_knobs("local", "cuda"),
            f"profile knobs {knobs}")
    return dict(rtt_ms=rtt, name=prof["name"], startup_rtt_ms=prof["rtt_ms"],
                knobs=knobs)


def busy_ticks(torch, asr, audios, n_ticks: int = 2):
    """The card's busy time (ms, torch.profiler) over n_ticks ticks of
    fresh sessions after a warm-up tick, and the steps they ran."""
    slots = [asr.join() for _ in audios]
    try:
        asr.tick({s: a[:CHUNK] for s, a in zip(slots, audios)})
        steps = asr.steps
        _, prof = profiled(torch, lambda: [
            asr.tick({s: a[c * CHUNK:(c + 1) * CHUNK]
                      for s, a in zip(slots, audios)})
            for c in range(1, 1 + n_ticks)])
    finally:
        for s in slots:
            asr.leave(s)
    busy = sum(e.self_device_time_total for e in _device_events(prof)) / 1e3
    require(busy > 0, "profiler saw no device time in the chunked steps")
    return busy, asr.steps - steps


def busy_per_step(torch, asr, audios, n_ticks: int = 2):
    """The card's busy time per chunked step over n_ticks ticks."""
    busy, steps = busy_ticks(torch, asr, audios, n_ticks)
    return busy / steps


def feed_ticks(asr, audios, n_ticks: int):
    """Join one session per audio and feed each its first n_ticks 0.4 s
    chunks, every session in every tick; leave without a finalize. Returns
    (per-tick (wall s, steps, True), per-session fired ids)."""
    slots = [asr.join() for _ in audios]
    back = {s: i for i, s in enumerate(slots)}
    ids = {i: [] for i in range(len(audios))}
    ticks = []
    try:
        for c in range(n_ticks):
            steps = asr.steps
            t0 = time.perf_counter()
            fired = asr.tick({s: a[c * CHUNK:(c + 1) * CHUNK]
                              for s, a in zip(slots, audios)})
            ticks.append((time.perf_counter() - t0, asr.steps - steps, True))
            for s, v in fired.items():
                ids[back[s]].extend(v)
    finally:
        for s in slots:
            asr.leave(s)
    return ticks, ids


def vad_ticks(vad, audios, n_ticks: int):
    """Join one VAD session per audio, tick every session's first n_ticks
    0.4 s chunks, leave. Returns each tick's wall (s)."""
    slots = [vad.join() for _ in audios]
    walls = []
    try:
        for c in range(n_ticks):
            t0 = time.perf_counter()
            vad.tick({s: a[c * CHUNK:(c + 1) * CHUNK]
                      for s, a in zip(slots, audios)})
            walls.append(time.perf_counter() - t0)
    finally:
        for s in slots:
            vad.leave(s)
    return walls


def capacity_sweep(torch, card, params):
    """For each hub capacity C: `BatchedChunkedASR(capacity=C)` and
    `BatchedVadTicker(capacity=C)`, all built first (captures, capture
    seconds, pool bytes), then timed in SWEEP_ROUNDS rounds (C ascending,
    then descending, so drift on the host reaches every C alike), each
    round with C new sessions fed SWEEP_TICKS chunks: the chunked step's
    wall median and p95 and the VAD tick's median over the rounds' ticks
    (each round's first tick left out), K1 50 / K2 1 per step and K1 4 / K2
    1 per VAD tick exactly, and the busy time per step. The rule: among the
    C whose step p95 stays under SWEEP_P95_MS, the largest C / (step +
    tick) wins, and within NEAR_BEST of it the smallest C."""
    import gc
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.models import fsmn_vad as fv
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer import (
        ParaformerConfig)
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer_online import (
        OnlineConfig)
    from toolbox_for_asr_and_tts_tpu_torch.parallel.stream_batcher import (
        BatchedChunkedASR, BatchedVadTicker)
    cfg, ocfg, vcfg = ParaformerConfig(), OnlineConfig(), fv.FsmnVadConfig()
    vparams = fv.init_params(vcfg, torch.Generator().manual_seed(0))
    tickers, audios, rows = {}, {}, {}
    for c in SWEEP_CAPACITIES:
        asr = BatchedChunkedASR(params, cfg, ocfg, capacity=c, partials=True)
        asr.warm()
        vad = BatchedVadTicker(vparams, vcfg, capacity=c)
        vad.warm()
        tickers[c] = (asr, vad)
        audios[c] = session_audio(c, seed=900 + c)   # every round's sessions
    snap = torch.cuda.memory_snapshot()
    steps = {c: [] for c in SWEEP_CAPACITIES}
    vads = {c: [] for c in SWEEP_CAPACITIES}
    order = list(SWEEP_CAPACITIES)
    for r in range(SWEEP_ROUNDS):
        for c in (order if r % 2 == 0 else order[::-1]):
            asr, vad = tickers[c]
            (ticks, _), k1_n, k2_n = counted(
                torch, lambda: feed_ticks(asr, audios[c], SWEEP_TICKS))
            n = sum(t[1] for t in ticks)
            require(k1_n == cfg.encoder_layers * n and k2_n == n,
                    f"sweep C={c}: K1 {k1_n}, K2 {k2_n} in {n} steps")
            steps[c] += [w / k * 1e3 for w, k, _ in ticks[1:]
                         for _ in range(k) if k]
            walls, k1_n, k2_n = counted(
                torch, lambda: vad_ticks(vad, audios[c], SWEEP_TICKS))
            require(k1_n == vcfg.fsmn_layers * SWEEP_TICKS
                    and k2_n == SWEEP_TICKS,
                    f"sweep VAD C={c}: K1 {k1_n}, K2 {k2_n} in "
                    f"{SWEEP_TICKS} ticks")
            vads[c] += [w * 1e3 for w in walls[1:]]
    for c in SWEEP_CAPACITIES:
        asr, vad = tickers[c]
        busy = busy_per_step(torch, asr, audios[c])
        t, v = asr.programs.stats(snap), vad.programs.stats(snap)
        step_med = float(np.median(steps[c]))
        vad_med = float(np.median(vads[c]))
        rows[c] = dict(
            step_median_ms=step_med,
            step_p95_ms=float(np.percentile(steps[c], 95)),
            busy_ms_per_step=busy, steps=len(steps[c]),
            k1_per_step=cfg.encoder_layers, k2_per_step=1,
            vad_tick_median_ms=vad_med,
            vad_tick_p95_ms=float(np.percentile(vads[c], 95)),
            vad_ticks=len(vads[c]),
            sessions_per_ms=c / (step_med + vad_med),
            captures=t["captures"] + v["captures"],
            capture_s=t["capture_s"] + v["capture_s"],
            pool_bytes=(t["pool_bytes"] or 0) + (v["pool_bytes"] or 0),
            chunked_pool_bytes=t["pool_bytes"])
        r = rows[c]
        print(f"capacity C={c}: chunked step median {step_med:.2f} ms, p95 "
              f"{r['step_p95_ms']:.2f} ms, busy {busy:.2f} ms/step "
              f"({r['steps']} steps timed, K1 {cfg.encoder_layers}, K2 1 per "
              f"step); VAD tick "
              f"median {vad_med:.2f} ms, p95 {r['vad_tick_p95_ms']:.2f} ms "
              f"({r['vad_ticks']} ticks, K1 {vcfg.fsmn_layers}, K2 1 per "
              f"tick); C / (step + tick) {r['sessions_per_ms']:.3f} "
              f"sessions/ms; {r['captures']} captures in "
              f"{r['capture_s']:.2f} s, pools {r['pool_bytes'] / 1e9:.3f} GB "
              f"(chunked {r['chunked_pool_bytes'] / 1e9:.3f}) on {card}",
              flush=True)
    graph_snapshot("dispatch")
    del tickers, asr, vad
    gc.collect()
    torch.cuda.empty_cache()
    ok = {c: r for c, r in rows.items() if r["step_p95_ms"] < SWEEP_P95_MS}
    require(ok, f"no capacity keeps the step p95 under {SWEEP_P95_MS} ms")
    best = max(r["sessions_per_ms"] for r in ok.values())
    pick = min(c for c, r in ok.items()
               if r["sessions_per_ms"] >= (1 - NEAR_BEST) * best)
    print(f"capacity rule: step p95 < {SWEEP_P95_MS:g} ms for {sorted(ok)}, "
          f"best {best:.3f} sessions/ms, the smallest within "
          f"{NEAR_BEST:.0%}: C = {pick}", flush=True)
    return dict(rows={str(c): r for c, r in rows.items()}, pick=pick)


def tts_groupings(torch, card, synth):
    """Phase 7's paragraph under each (TTS_GROUP_BY_LENGTH, TTS_MEL_GROUP):
    wall (median of TTS_GROUP_CALLS after a capturing call), first audio of
    `synthesize_stream`, the card's busy time over one call, captures and
    pool bytes, and the max |d| in LSB against the off/off PCM. The rule:
    the lowest wall, each knob of it on only where it saves KNOB_SAVING."""
    import numpy as np
    settings = ((False, False), (True, False), (False, True), (True, True))
    rows, pcm = {}, {}
    try:
        for gl, mg in settings:
            synth.group_by_length, synth.mel_group = gl, mg
            captures0, capture_s0 = (synth.programs.captures,
                                     synth.programs.capture_s)
            first = synth.synthesize(TTS_TEXT)         # captures new buckets
            walls = []
            for _ in range(TTS_GROUP_CALLS):
                t0 = time.perf_counter()
                synth.synthesize(TTS_TEXT)
                walls.append((time.perf_counter() - t0) * 1e3)
            t0, ttfa = time.perf_counter(), None
            for ev in synth.synthesize_stream(TTS_TEXT):
                if ttfa is None and ev["event"] == "chunk":
                    ttfa = (time.perf_counter() - t0) * 1e3
            _, prof = profiled(torch, lambda: synth.synthesize(TTS_TEXT))
            busy = sum(e.self_device_time_total
                       for e in _device_events(prof)) / 1e3
            pcm[gl, mg] = pcm16(first.wav)
            key = f"length={int(gl)},mel={int(mg)}"
            rows[key] = dict(
                group_by_length=gl, mel_group=mg,
                wall_ms=float(np.median(walls)), walls_ms=walls,
                first_audio_ms=ttfa, busy_ms=busy,
                audio_s=len(first.wav) / SR,
                captures=synth.programs.captures - captures0,
                capture_s=synth.programs.capture_s - capture_s0,
                pool_bytes=synth.programs.stats(
                    torch.cuda.memory_snapshot())["pool_bytes"])
    finally:
        tts_pin(synth)
    base = pcm[False, False]
    for (gl, mg), p in pcm.items():
        r = rows[f"length={int(gl)},mel={int(mg)}"]
        n = min(len(p), len(base))
        r["samples"], r["max_lsb_vs_off"] = len(p), int(
            np.abs(p[:n] - base[:n]).max())
        print(f"tts grouping length={int(gl)} mel={int(mg)}: wall "
              f"{r['wall_ms']:.1f} ms (median of {TTS_GROUP_CALLS}) for "
              f"{r['audio_s']:.2f} s of audio ({r['wall_ms'] / r['audio_s']:.3f}"
              f" ms per audio second), first "
              f"audio {r['first_audio_ms']:.1f} ms, card busy "
              f"{r['busy_ms']:.1f} ms, {r['captures']} captures in "
              f"{r['capture_s']:.2f} s, pool {r['pool_bytes'] / 1e9:.3f} GB;"
              f" {len(p)} samples ({len(base)} off/off), max |d| "
              f"{r['max_lsb_vs_off']} LSB against off/off on {card}",
              flush=True)
    wall = {(v["group_by_length"], v["mel_group"]): v["wall_ms"]
            for v in rows.values()}
    gl, mg = min(wall, key=wall.get)
    # a knob of the fastest setting stays on only if turning it off costs
    # KNOB_SAVING of the wall or more
    keep_gl = gl and wall[gl, mg] <= (1 - KNOB_SAVING) * wall[False, mg]
    keep_mg = mg and wall[gl, mg] <= (1 - KNOB_SAVING) * wall[gl, False]
    pick = dict(tts_group_by_length=bool(keep_gl), tts_mel_group=bool(keep_mg))
    print(f"tts grouping rule: fastest length={int(gl)} mel={int(mg)}; with "
          f"the {KNOB_SAVING:.0%} rule: {pick}", flush=True)
    return dict(rows=rows, pick=pick)


def int16_upload(torch, card, reco, params):
    """Phase 3's 8 rows quantized to PCM first, through the f32 and the
    int16 upload (two Recognizers on phase 3's weights, the mode set by
    PARAFORMER_TRANSFER_INT16 at construction): fbank and ids bit-equal,
    K1 66 / K2 1 per transcribe on both, the wall (median of INT16_CALLS,
    alternating); then the chunked step at S = 64 under both: ids equal,
    K1 50 / K2 1 per step. The rule: on only if int16 saves KNOB_SAVING."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import (
        Recognizer, from_int16_pcm, to_int16_pcm)
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer_online import (
        OnlineConfig)
    from toolbox_for_asr_and_tts_tpu_torch.ops import frontend as fe
    from toolbox_for_asr_and_tts_tpu_torch.parallel.stream_batcher import (
        BatchedChunkedASR)
    wavs = [to_int16_pcm(w) / np.float32(32768.0) for w in make_wavs()]
    enc, dec = reco.cfg.encoder_layers, reco.cfg.decoder_layers
    cmvn = None if reco.cmvn is None else tuple(c.cpu().numpy()
                                                for c in reco.cmvn)
    recos, out = {}, {}
    for mode in ("f32", "int16"):
        os.environ["PARAFORMER_TRANSFER_INT16"] = "1" if mode == "int16" \
            else "0"
        try:
            recos[mode] = Recognizer(params, reco.cfg, reco.tokenizer,
                                     cmvn=cmvn)
        finally:
            del os.environ["PARAFORMER_TRANSFER_INT16"]
        require(recos[mode]._int16_transfer is (mode == "int16"),
                f"{mode}: the upload mode")
    batch, _ = reco.bucketer.pad_batch(wavs)
    x = torch.from_numpy(batch).cuda()
    with torch.inference_mode():
        fb32 = fe.fbank(x, reco.fe_cfg)
        fb16 = fe.fbank(from_int16_pcm(torch.from_numpy(
            to_int16_pcm(batch)).cuda()), reco.fe_cfg)
    require(torch.equal(fb32, fb16), "fbank of the int16 upload differs")
    ids, walls, counts = {}, {"f32": [], "int16": []}, {}
    for mode, r in recos.items():
        res, k1_n, k2_n = counted(torch, lambda: r.transcribe(wavs))
        require(k1_n == enc + dec and k2_n == 1,
                f"{mode}: K1 {k1_n}, K2 {k2_n} per transcribe")
        ids[mode], counts[mode] = [x.token_ids for x in res], (k1_n, k2_n)
    require(ids["f32"] == ids["int16"], "int16 ids differ from f32's")
    for _ in range(INT16_CALLS):
        for mode, r in recos.items():
            t0 = time.perf_counter()
            r.transcribe(wavs)
            walls[mode].append((time.perf_counter() - t0) * 1e3)
    for mode in recos:
        out[mode] = dict(wall_ms=float(np.median(walls[mode])),
                         walls_ms=walls[mode],
                         k1_per_transcribe=counts[mode][0],
                         k2_per_transcribe=counts[mode][1])
    saving = 1 - out["int16"]["wall_ms"] / out["f32"]["wall_ms"]
    out["saving"] = saving
    print(f"int16 upload: 8 rows quantized to PCM, fbank bit-equal, ids "
          f"equal ({sum(len(i) for i in ids['f32'])} tokens), K1 "
          f"{enc + dec} / K2 1 per transcribe on both; transcribe wall "
          f"median f32 {out['f32']['wall_ms']:.2f} ms, int16 "
          f"{out['int16']['wall_ms']:.2f} ms (saving {saving:.1%}) on {card}",
          flush=True)
    del recos
    # the chunked step at S = 64 under both uploads
    audios = [to_int16_pcm(a) / np.float32(32768.0)
              for a in session_audio(64, seed=990)]
    fired = {}
    for mode in ("f32", "int16"):
        os.environ["PARAFORMER_TRANSFER_INT16"] = "1" if mode == "int16" \
            else "0"
        try:
            asr = BatchedChunkedASR(params, reco.cfg, OnlineConfig(),
                                    capacity=64, partials=True, cmvn=cmvn)
        finally:
            del os.environ["PARAFORMER_TRANSFER_INT16"]
        require(asr._int16_transfer is (mode == "int16"), "ticker mode")
        (ticks, fired[mode]), k1_n, k2_n = counted(
            torch, lambda: feed_ticks(asr, audios, 4))
        n = sum(t[1] for t in ticks)
        require(k1_n == enc * n and k2_n == n,
                f"chunked {mode}: K1 {k1_n}, K2 {k2_n} in {n} steps")
        out[f"chunked_{mode}"] = dict(steps=n, k1_per_step=k1_n / n,
                                      k2_per_step=k2_n / n)
        del asr
    require(fired["f32"] == fired["int16"],
            "chunked ids under the int16 upload differ from f32's")
    print(f"int16 upload: chunked step S=64, 4 ticks: ids equal "
          f"({sum(len(v) for v in fired['f32'].values())} tokens), K1 "
          f"{enc} / K2 1 per step under both uploads", flush=True)
    out["pick"] = bool(saving >= KNOB_SAVING)
    return out


def framing_switch_raises(torch):
    """USE_PALLAS_FRAMING=0 (and the module flag False) with a CUDA tensor
    raises: the card always frames with K2."""
    from toolbox_for_asr_and_tts_tpu_torch.ops import frontend as fe
    x = torch.zeros((1, SR), device="cuda")
    raised = []
    os.environ["USE_PALLAS_FRAMING"] = "0"
    try:
        fe.fbank(x)
    except ValueError as e:
        raised.append(str(e))
    finally:
        del os.environ["USE_PALLAS_FRAMING"]
    fe.USE_PALLAS_FRAMING = False
    try:
        fe.fbank(x)
    except ValueError as e:
        raised.append(str(e))
    finally:
        fe.USE_PALLAS_FRAMING = None
    require(len(raised) == 2, "the framing switch off did not raise on the card")
    fe.fbank(x)                       # on again: K2
    print(f"USE_PALLAS_FRAMING=0 and the flag False on a CUDA tensor raise: "
          f"{raised[0]!r}", flush=True)
    return len(raised)


def rehearsal(torch, card, root: str, rest_text: str):
    """`tools/rehearse.py` over phase 8's mount, as `cli rehearse root
    --reconvert --golden-wav W --report R` runs it (R under the run's temp
    dir; W the 8 s audio of phase 8's REST request): every family
    converted with 0 missing and 0 unmapped, exit status 0, the REST text
    equal to phase 8's mounted service's, a WS final, a TTS WAV; K1 / K2
    launches of the REST drive held to its programs (66 / 1 per
    transcribe); seconds for convert, boot and each drive."""
    import logging
    import shutil
    import tempfile
    from toolbox_for_asr_and_tts_tpu_torch.service import engines as E
    from toolbox_for_asr_and_tts_tpu_torch.tools import rehearse as R
    from toolbox_for_asr_and_tts_tpu_torch.utils.audio import write_wav
    work = tempfile.mkdtemp(prefix="rehearsal-")
    golden = os.path.join(work, "golden.wav")
    write_wav(golden, make_wavs()[5][: 8 * SR], SR)
    report_path = os.path.join(work, "rehearsal_report.json")
    seen = {}
    build, rest = E.build_engines, R._rest_asr

    def build_engines(*a, **k):
        seen["engines"] = build(*a, **k)
        return seen["engines"]

    def rest_accounted(port, b64):
        eng = seen["engines"]
        diar = eng.diarizer.inner
        models = (diar.recognizer, diar.verifier, diar.punctuator,
                  eng.kws.inner)
        out, seen["rest"] = accounted(torch, "rehearsal REST", eng, models,
                                      lambda: rest(port, b64))
        return out
    E.build_engines, R._rest_asr = build_engines, rest_accounted
    level = logging.getLogger().level
    t0 = time.perf_counter()
    try:
        R.main([root, "--reconvert", "--golden-wav", golden,
                "--report", report_path])
    except SystemExit as e:
        raise PhaseError(f"rehearse exited with status {e.code}") from e
    finally:
        E.build_engines, R._rest_asr = build, rest
        logging.getLogger().setLevel(level)
    wall = time.perf_counter() - t0
    with open(report_path, encoding="utf-8") as f:
        report = json.load(f)
    shutil.rmtree(work, ignore_errors=True)
    fams = report["families"]
    for key, v in fams.items():
        require(v["status"] == "converted" and v["missing"] == []
                and v["unmapped"] == [],
                f"rehearsal {key}: {v['status']}, missing "
                f"{v.get('missing', [])[:3]}, unmapped "
                f"{v.get('unmapped', [])[:3]}")
    svc = report["service"]
    require(report["ok"] and svc["rest_asr"]["text"] == rest_text,
            f"rehearsal REST text {svc['rest_asr']['text']!r} vs phase 8's "
            f"{rest_text!r}")
    require(svc["ws_asr"]["ok"] and svc["tts"]["status"] == "completed"
            and svc["tts"]["audio_size"] > 0 and not svc["tts"][
                "random_weights"], f"rehearsal drives {svc}")
    n = seen["rest"]
    require(n["transcribes"] >= 1, "the REST drive ran no transcribe")
    convert_s = sum(v["seconds"] for v in fams.values())
    print(f"rehearsal: {len(fams)} families converted (rules "
          f"{sum(v['n_rules'] for v in fams.values())}, 0 missing, 0 "
          f"unmapped) in {convert_s:.1f} s ("
          + ", ".join(f"{k} {v['seconds']:.2f}" for k, v in fams.items())
          + f"); engines built in {svc['boot_seconds']:.1f} s; REST "
          f"{svc['rest_asr']['seconds']:.2f} s (text equals phase 8's, "
          f"{n['transcribes']} transcribes, K1 {n['k1']}, K2 {n['k2']}), WS "
          f"{svc['ws_asr']['seconds']:.2f} s (frames "
          f"{svc['ws_asr']['frames']}), TTS job {svc['tts']['seconds']:.2f} s"
          f" ({svc['tts']['audio_size']} base64 bytes); exit status 0 in "
          f"{wall:.1f} s on {card}", flush=True)
    return dict(families={k: {f: v[f] for f in ("status", "seconds",
                                                "n_rules", "n_converted")}
                          for k, v in fams.items()},
                convert_s=convert_s, boot_s=svc["boot_seconds"],
                rest_s=svc["rest_asr"]["seconds"],
                ws_s=svc["ws_asr"]["seconds"], tts_s=svc["tts"]["seconds"],
                ws_frames=svc["ws_asr"]["frames"], wall_s=wall,
                rest_launches=n)


def dispatch_path(torch, card, reco, synth, root: str, rest_text: str):
    """Phase 12: the dispatch profile and the rehearsal."""
    t_phase = time.perf_counter()
    out = dict(probe=probe_profile(torch, card),
               capacity=capacity_sweep(torch, card, reco.params),
               tts_grouping=tts_groupings(torch, card, synth),
               int16=int16_upload(torch, card, reco, reco.params),
               framing_switch_raises=framing_switch_raises(torch))
    from toolbox_for_asr_and_tts_tpu_torch.runtime import autotune as at
    chosen = dict(batch_capacity=out["capacity"]["pick"],
                  asr_int16_transfer=out["int16"]["pick"],
                  **out["tts_grouping"]["pick"])
    held = {k: at.CUDA_LOCAL[k] for k in chosen}
    out["rules_pick"], out["profile_holds"] = chosen, held
    print(f"dispatch rules pick {chosen}; the cuda local profile holds "
          f"{held}" + ("" if chosen == held else " (differs: see PERF.md)"),
          flush=True)
    out["rehearsal"] = rehearsal(torch, card, root, rest_text)
    graph_snapshot("dispatch")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"dispatch phase: {out['phase_s']:.1f} s", flush=True)
    return out


# ------------------------------------------------ phase 13: the mesh layer
MESH_SEQ_SECONDS = 60.0      # (d): one long row
MESH_SEQ_POSITIONS = 4
MESH_SEQ_TOL = 2e-4          # (d): max |enc - encode|, the reference test's
MESH_PIPE_STAGES = 7         # (e): 49 layers, 7 per stage
MESH_PIPE_MICRO = 8          # (e): one row per microbatch
MESH_PIPE_OUT_TOL = 1e-4     # (e): max |y - encode| (layernormed, O(1))
MESH_PIPE_GRAD_REL = 1e-3    # (e): per leaf, |g - g_seq| / |g_seq| (norms,
                             # phase 10's rule: one row per microbatch
                             # against 8-row GEMMs, summed over 49 layers)
MESH_TICK_CAPACITY = 64      # (b)
MESH_TICK_SESSIONS = 16
MESH_TICK_CHUNKS = 8
MESH_TP_GRAD_REL = 1e-2      # (f): per leaf, |g - g_single| / |g_single|:
                             # 4-row GEMMs and split products against 8-row
                             # ones; a decoder layer's FFN LayerNorm over a
                             # sparse ReLU output amplifies their rounding
                             # (1.7e-3 at decoder layer 9, the worst)
MESH_TP_UPDATE_TOL = 1e-6    # (f): |updated - single-device| on 99.9 % of
                             # elements; every element within 2 lr, since
                             # AdamW's first step moves one by about
                             # lr·g/(|g|+eps), whose sign a near-zero
                             # gradient decides


class mesh_positions:
    """Within the block, `runtime/mesh.py::serving_mesh` covers `devices`
    (a list that may repeat one card), as the CPU tests widen it."""

    def __init__(self, devices):
        self.devices = list(devices)

    def __enter__(self):
        from toolbox_for_asr_and_tts_tpu_torch.runtime import mesh as M
        self.saved = M.local_devices
        M.local_devices = lambda platform="cuda": list(self.devices)
        return self

    def __exit__(self, *exc):
        from toolbox_for_asr_and_tts_tpu_torch.runtime import mesh as M
        M.local_devices = self.saved


def mesh_layouts(torch):
    """(name, positions) of the recognizer and ticker meshes: two positions
    on card 0, and every card where the machine has more than one."""
    n = torch.cuda.device_count()
    c0 = torch.device("cuda", 0)
    out = [("2 positions on cuda:0", [c0, c0])]
    if n > 1:
        out.append((f"{n} cards", [torch.device("cuda", i)
                                   for i in range(n)]))
    return out


def position_launches(owners, key_of, before):
    """Per position: (K1, K2) its program ran since `before` (its replays
    times its capture's tally)."""
    out = []
    for owner, b in zip(owners, before):
        prog = owner._progs[key_of]
        runs = prog.replays - b
        out.append((runs * prog.tally.get("fsmn_conv", 0),
                    runs * prog.tally.get("frame_window", 0)))
    return out


def mesh_transcribe(torch, card, reco, wavs):
    """(a) `Recognizer(use_mesh=True)` over `serving_mesh()` and over each
    of `mesh_layouts`, against `use_mesh=False` on phase 3's 8 rows: ids
    and counts equal, each position's packed floats (CIF centers) within
    1e-3 of the meshless forward's, each position K1 66 / K2 1 per
    transcribe; the walls (median of 5)."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import (
        Recognizer, to_int16_pcm)
    layers = reco.cfg.encoder_layers + reco.cfg.decoder_layers

    def build(use_mesh):
        return Recognizer(reco.params, reco.cfg, reco.tokenizer,
                          device="cuda", use_mesh=use_mesh)

    def wall(r):
        r.transcribe(wavs)                  # captures
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.transcribe(wavs)
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    def packed(r, batch, lens):
        n = len(r._positions)
        per = batch.shape[0] // n
        x = to_int16_pcm(batch) if r._int16_transfer else batch
        return np.concatenate([r._fn_for(per, batch.shape[1], i)(
            x[i * per:(i + 1) * per], lens[i * per:(i + 1) * per],
            read=lambda d: d["packed"].cpu().numpy()) for i in range(n)])

    alone = build(False)
    want = alone.transcribe(wavs)
    batch, lens = alone.bucketer.pad_batch(wavs)
    batch = np.asarray(batch, np.float32)
    want_packed = packed(alone, batch, lens)
    _, k_max = alone._bucket_shapes(batch.shape[1])
    out = dict(meshless_ms=wall(alone))
    runs = [("serving_mesh()", None)] + mesh_layouts(torch)
    for name, positions in runs:
        if positions is None:
            r = build(True)
        else:
            with mesh_positions(positions):
                r = build(True)
        n = len(r._positions)
        got = r.transcribe(wavs)
        require([x.token_ids for x in got] == [x.token_ids for x in want],
                 f"mesh transcribe over {name}: ids differ from use_mesh="
                 "False")
        b2, l2 = r.bucketer.pad_batch(wavs, batch_multiple=n)
        p = packed(r, np.asarray(b2, np.float32), l2)[:len(wavs)]
        q = want_packed[:len(wavs)]
        require((p[:, :1 + k_max] == q[:, :1 + k_max]).all(),
                f"mesh over {name}: counts or tokens differ")
        dcenter = float(np.abs(p[:, 1 + k_max:] - q[:, 1 + k_max:]).max())
        require(dcenter <= 1e-3, f"mesh over {name}: packed floats differ "
                                 f"by {dcenter}")
        per = b2.shape[0] // n
        key = ("forward", per, b2.shape[1], r._int16_transfer)
        before = [o._progs[key].replays for o in r._positions]
        _, k1n, k2n = counted(torch, lambda: r.transcribe(wavs))
        per_pos = position_launches(r._positions, key, before)
        require(all(c == (layers, 1) for c in per_pos),
                f"mesh over {name}: per-position K1 / K2 {per_pos}, "
                f"expected ({layers}, 1) each")
        require((k1n, k2n) == (layers * n, n), f"mesh over {name}: K1 / K2 "
                f"{k1n} / {k2n} in all, expected {layers * n} / {n}")
        ms = wall(r)
        print(f"mesh (a) transcribe over {name} ({n} positions, "
              f"{[str(d) for d in r.mesh.positions()]}): ids equal to "
              f"use_mesh=False on {len(wavs)} rows, packed floats max|d| "
              f"{dcenter:.3g} (tol 1e-3), per position K1 / K2 {per_pos}, "
              f"wall {ms:.2f} ms (use_mesh=False {out['meshless_ms']:.2f} "
              f"ms; {card})", flush=True)
        out[name] = dict(positions=n, devices=[str(d) for d in
                                               r.mesh.positions()],
                         max_abs_dfloat=dcenter, per_position=per_pos,
                         k1=k1n, k2=k2n, ms=ms)
    return out


def mesh_ticker(torch, card, params):
    """(b) `BatchedChunkedASR(capacity=64, partials=True)` over each of
    `mesh_layouts` against the meshless ticker: 16 sessions fed 8 chunks
    each then finalized, every session's ids equal; K1 50 / K2 1 per
    step, one step per position per tick."""
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer import (
        ParaformerConfig)
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer_online import (
        OnlineConfig)
    from toolbox_for_asr_and_tts_tpu_torch.parallel.stream_batcher import (
        BatchedChunkedASR)
    from toolbox_for_asr_and_tts_tpu_torch.runtime.mesh import Mesh
    cfg = ParaformerConfig()
    audios = [a[:MESH_TICK_CHUNKS * CHUNK]
              for a in session_audio(MESH_TICK_SESSIONS, seed=13)]

    def run(ticker):
        ticker.warm()
        steps = ticker.steps
        (ticks, ids, finals), k1n, k2n = counted(
            torch, lambda: drive_chunked(ticker, audios))
        n_steps = ticker.steps - steps
        require((k1n, k2n) == (cfg.encoder_layers * n_steps, n_steps),
                f"mesh ticker: K1 / K2 {k1n} / {k2n} over {n_steps} steps")
        return ids, finals, n_steps, statistics.median(
            t for t, _, full in ticks if full) * 1e3
    ids0, fin0, steps0, ms0 = run(BatchedChunkedASR(
        params, cfg, OnlineConfig(), capacity=MESH_TICK_CAPACITY,
        partials=True, device="cuda"))
    require(sum(len(v) for v in ids0.values()) > 0, "the ticker fired "
            "no token")
    out = dict(meshless=dict(steps=steps0, tick_ms=ms0))
    for name, positions in mesh_layouts(torch):
        t = BatchedChunkedASR(params, cfg, OnlineConfig(),
                              capacity=MESH_TICK_CAPACITY, partials=True,
                              mesh=Mesh(positions, ("data",)))
        ids, fin, steps, ms = run(t)
        require(ids == ids0 and fin == fin0,
                f"mesh ticker over {name}: ids differ from the meshless "
                "ticker's")
        print(f"mesh (b) chunked ticker C={MESH_TICK_CAPACITY} over {name}: "
              f"{MESH_TICK_SESSIONS} sessions x {MESH_TICK_CHUNKS} chunks, "
              f"partial and final ids equal to the meshless ticker's "
              f"({sum(len(v) for v in ids.values())} tokens); {steps} steps "
              f"({steps0} meshless), K1 {cfg.encoder_layers} / K2 1 per "
              f"step; tick median {ms:.2f} ms ({ms0:.2f} meshless; {card})",
              flush=True)
        out[name] = dict(steps=steps, tick_ms=ms, rows_per=t.rows_per)
    return out


def mesh_synth(torch, card, synth):
    """(c) `Synthesizer(use_mesh=True)` over each of `mesh_layouts` against
    `use_mesh=False`, both pinned as phase 7 (NAR, one call per batch): the
    first 3 segments (3 rows pad to the positions), equal durations, PCM
    within TTS_PCM_LSB."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.tts.synthesizer import Synthesizer
    segs = tts_segments(synth)[:3]
    want, dwant = tts_pin(Synthesizer(
        synth.ap, synth.acfg, synth.vp, synth.vcfg,
        device="cuda")).synthesize_segments(segs, "zhitian_emo")
    out = {}
    for name, positions in mesh_layouts(torch):
        with mesh_positions(positions):
            s = tts_pin(Synthesizer(synth.ap, synth.acfg, synth.vp,
                                    synth.vcfg, device="cuda",
                                    use_mesh=True))
        got, dgot = s.synthesize_segments(segs, "zhitian_emo")
        require(dgot == dwant, f"mesh synth over {name}: durations differ")
        lsb = max(int(np.abs(np.round(a * 32767) - np.round(b * 32767))
                      .max()) for a, b in zip(got, want))
        require(lsb <= TTS_PCM_LSB, f"mesh synth over {name}: PCM differs "
                                    f"by {lsb} LSB")
        print(f"mesh (c) synthesizer over {name}: {len(segs)} segments on "
              f"{len(s._positions)} positions, durations equal, PCM max|d| "
              f"{lsb} LSB (limit {TTS_PCM_LSB})", flush=True)
        out[name] = dict(segments=len(segs), lsb=lsb)
    return out


def long_row(wavs):
    import numpy as np
    x = np.concatenate(list(wavs) * 2)
    return x[:int(MESH_SEQ_SECONDS * SR)]


def mesh_seq_parallel(torch, card, peaks, floor_ms, params, cfg, wavs):
    """(d) `encode_seq_parallel` over 4 positions of card 0 on one 60 s row
    against `paraformer.encode` (max |d| within the reference test's
    2e-4), `transcribe_long_forward`'s ids against `paraformer.forward`'s;
    K1 once per layer per position, on the gathered V (timed beside its
    plain version, its library yardstick and its bound)."""
    from toolbox_for_asr_and_tts_tpu_torch.models import paraformer
    from toolbox_for_asr_and_tts_tpu_torch.ops import frontend as fe
    from toolbox_for_asr_and_tts_tpu_torch.ops import nn
    from toolbox_for_asr_and_tts_tpu_torch.parallel import seqparallel as sq
    from toolbox_for_asr_and_tts_tpu_torch.parallel.sharding import (
        make_2d_mesh)
    dev = torch.device("cuda", 0)
    n = MESH_SEQ_POSITIONS
    mesh = make_2d_mesh(n, 1, devices=[dev] * n)
    wav = torch.from_numpy(long_row(wavs))[None].to(dev)
    with torch.inference_mode():
        feats = fe.compute_frontend(wav, cfg.frontend)
        t = feats.shape[1]
        lens = torch.tensor([t], device=dev)
        mask = nn.length_mask(lens, t)
        fp, mp = sq.pad_to_blocks(feats, mask, n)
        want = paraformer.encode(params, fp, mp, cfg)
        got, k1n, _ = counted(torch, lambda: sq.encode_seq_parallel(
            params, fp, mp, cfg, mesh))
        d = (got - want).abs().max().item()
        k_max = paraformer.max_tokens_for(t)
        long_ = sq.transcribe_long_forward(params, feats, lens, k_max, cfg,
                                           mesh)
        plain = paraformer.forward(params, feats, lens, k_max, cfg)
    require(k1n == cfg.encoder_layers * n, f"seq-parallel K1 {k1n}, "
            f"expected {cfg.encoder_layers * n}")
    require(d <= MESH_SEQ_TOL, f"seq-parallel encode max|d| {d}")
    same = (torch.equal(long_["tokens"], plain["tokens"])
            and torch.equal(long_["token_count"], plain["token_count"]))
    require(same, "transcribe_long_forward's ids differ from forward's")
    require(int(plain["token_count"].sum()) > 0, "the long row fired no "
                                                 "token")
    # K1 at the gathered V: a contiguous [1, T_padded, 512] on every position
    g = torch.Generator(device=dev).manual_seed(5)
    xv = torch.randn((1, fp.shape[1], K1_D), generator=g, device=dev)
    w = torch.randn((K1_D, 1, K1_K), generator=g, device=dev) * 0.02
    row = k1_measure(torch, peaks, floor_ms, "seq-parallel gathered V", xv,
                     w, K1_PAD, mp.float().contiguous(), 0.0,
                     conv_plus_x(K1_PAD))
    row["launches_per_encode"] = k1n
    print(f"mesh (d) sequence parallel: {MESH_SEQ_SECONDS:.0f} s row, T "
          f"{t} (padded {fp.shape[1]}) over {n} positions on cuda:0: max|enc "
          f"- encode| {d:.3g} (tol {MESH_SEQ_TOL}), long-form ids equal "
          f"({int(plain['token_count'].sum())} tokens), K1 {k1n} per encode "
          f"({card})", flush=True)
    return dict(seconds=MESH_SEQ_SECONDS, t=t, t_padded=fp.shape[1],
                positions=n, max_abs_d=d, tol=MESH_SEQ_TOL, ids_equal=same,
                k1_per_encode=k1n, k1_row=row)


def mesh_batch(torch, cfg, wavs, k_max, vocab: int):
    """Phase 10's batch: the 8 rows with random targets from a fixed seed
    (3 tokens per second, at most k_max), features on the card."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.tools import finetune
    rng = np.random.default_rng(9)
    items = [(w, list(rng.integers(4, vocab, min(k_max, max(
        1, int(3 * len(w) / SR)))))) for w in wavs]
    return finetune._features(items, cfg.frontend, k_max,
                              torch.device("cuda", 0))


def mesh_pipeline(torch, card, peaks, floor_ms, params, cfg, batch):
    """(e) `encode_pipelined`: the 49 layers after layer 0 in 7 stages on
    7 positions of card 0, 8 microbatches of phase 10's 8 rows; outputs and
    the stage parameters' gradients against the plain encoder's, restacked;
    K1 and K1's backward launches. The loss is Σ y·r for a fixed random r:
    the reference test's Σ y² has no gradient before the final LayerNorm
    in exact arithmetic (a normalized row's Σ y² is fixed), so its
    gradients there are rounding noise."""
    from toolbox_for_asr_and_tts_tpu_torch.models import paraformer
    from toolbox_for_asr_and_tts_tpu_torch.models.convert import tree_map
    from toolbox_for_asr_and_tts_tpu_torch.ops import nn
    from toolbox_for_asr_and_tts_tpu_torch.ops.kernels import (
        fsmn_conv_dw as kdw)
    from toolbox_for_asr_and_tts_tpu_torch.parallel import pipeline as pp
    from toolbox_for_asr_and_tts_tpu_torch.parallel.sharding import (
        _flat_paths, make_2d_mesh)
    dev = torch.device("cuda", 0)
    s = MESH_PIPE_STAGES
    mesh = make_2d_mesh(s, s, devices=[dev] * s)
    feats = batch["feats"]
    mask = nn.length_mask(batch["feat_lens"], feats.shape[1])
    layers = params["encoder"]["layers"]
    stage = tree_map(lambda a: a.detach().requires_grad_(True),
                     pp.stack_stage_params(layers, s))
    proj = torch.randn((feats.shape[0], feats.shape[1], cfg.d_model),
                       generator=torch.Generator(device=dev).manual_seed(8),
                       device=dev)
    torch.cuda.synchronize()
    kdw.launches = 0
    t0 = time.perf_counter()
    y, k1n, _ = counted(torch, lambda: pp.encode_pipelined(
        params, stage, feats, mask, cfg, mesh, n_micro=MESH_PIPE_MICRO))
    torch.cuda.synchronize()
    kdw.launches = 0
    (y * proj).sum().backward()
    torch.cuda.synchronize()
    bwd = kdw.launches
    pipe_s = time.perf_counter() - t0
    rest = [tree_map(lambda a: a.detach().requires_grad_(True), ly)
            for ly in layers[1:]]
    p2 = dict(params, encoder=dict(params["encoder"],
                                   layers=[layers[0]] + rest))
    y2 = paraformer.encode(p2, feats, mask, cfg)
    (y2 * proj).sum().backward()
    g_seq = pp.stack_stage_params([None] + tree_map(lambda a: a.grad, rest),
                                  s)
    dy = (y - y2).abs().max().item()
    got = dict(_flat_paths(tree_map(lambda a: a.grad, stage)))
    ref = dict(_flat_paths(g_seq))
    rel = {k: ((got[k] - ref[k]).norm() / ref[k].norm()).item() for k in ref}
    rel_max = {k: ((got[k] - ref[k]).abs().max()
                   / ref[k].abs().max()).item() for k in ref}
    worst_leaf = max(rel, key=rel.get)
    worst = rel[worst_leaf]
    n_pipe = cfg.encoder_layers - 1
    want_k1 = 1 + n_pipe * MESH_PIPE_MICRO
    require(k1n == want_k1, f"pipeline K1 {k1n}, expected {want_k1}")
    require(bwd == n_pipe * MESH_PIPE_MICRO, f"pipeline K1 backward {bwd}, "
            f"expected {n_pipe * MESH_PIPE_MICRO}")
    require(dy <= MESH_PIPE_OUT_TOL, f"pipeline output max|d| {dy}")
    require(worst <= MESH_PIPE_GRAD_REL, f"pipeline gradient rel {worst}")
    # K1 at the per-microbatch V view: [1, T, 512] of a [1, T, 1536] qkv
    g = torch.Generator(device=dev).manual_seed(6)
    t = feats.shape[1]
    xv = torch.randn((1, t, 3 * K1_D), generator=g, device=dev)[..., 2 * K1_D:]
    w = torch.randn((K1_D, 1, K1_K), generator=g, device=dev) * 0.02
    row = k1_measure(torch, peaks, floor_ms, "pipeline microbatch V", xv, w,
                     K1_PAD, mask[:1].contiguous(), 0.0, conv_plus_x(K1_PAD))
    row["launches_per_forward"] = k1n
    el = 4
    small = K1_D * K1_K * 4 * 2 + t * 4
    bwd_bound, bwd_by = bound(3 * t * K1_D * el + small,
                              (4 * K1_K + 2) * t * K1_D, peaks)
    gv = torch.randn((1, t, K1_D), generator=g, device=dev)
    m1 = mask[:1].contiguous()
    bwd_ms = device_ms(torch, lambda: kdw.fsmn_conv_bwd(xv, gv, w, *K1_PAD,
                                                        m1))
    bwd_plain_ms = device_ms(torch, lambda: kdw.fsmn_conv_bwd_plain(
        xv, gv, w, *K1_PAD, m1))
    bwd_library_ms = device_ms(torch, lambda: conv_backward(
        torch, K1_PAD, "both")(xv, gv, w))
    print(f"mesh (e) pipeline: {n_pipe} layers in {s} stages on {s} "
          f"positions of cuda:0, {MESH_PIPE_MICRO} microbatches of "
          f"{feats.shape[0] // MESH_PIPE_MICRO} row(s), T {t}: max|y - "
          f"encode| {dy:.3g} (tol {MESH_PIPE_OUT_TOL}), worst leaf gradient "
          f"|d| / |g| {worst:.3g} ({worst_leaf}; tol {MESH_PIPE_GRAD_REL}), "
          f"max|d| / max|g| {max(rel_max.values()):.3g} "
          f"({max(rel_max, key=rel_max.get)}); K1 {k1n} "
          f"forward, K1 backward {bwd}; forward + backward {pipe_s:.2f} s; "
          f"K1 backward at [1, {t}, 512] {bwd_ms * 1e3:.2f} us, plain "
          f"{bwd_plain_ms * 1e3:.2f} us, library {bwd_library_ms * 1e3:.2f} "
          f"us, bound {bwd_bound * 1e3:.2f} us ({bwd_by}; {card})",
          flush=True)
    return dict(stages=s, layers=n_pipe, micro=MESH_PIPE_MICRO, t=t,
                max_abs_dy=dy, out_tol=MESH_PIPE_OUT_TOL, grad_rel=worst,
                grad_rel_leaf=worst_leaf, grad_tol=MESH_PIPE_GRAD_REL,
                grad_max_rel=max(rel_max.values()), k1=k1n, k1_backward=bwd,
                seconds=pipe_s, k1_row=row,
                k1_backward_row=dict(shape=[1, t, K1_D, K1_K], ms=bwd_ms,
                                     plain_ms=bwd_plain_ms,
                                     library_ms=bwd_library_ms,
                                     bound_ms=bwd_bound, bound_by=bwd_by))


def mesh_train(torch, card, cfg, batch):
    """(f) one dp + tp step (`make_train_step(cfg, mesh=...)`) on
    `make_2d_mesh(4, model_parallel=2)` of card 0, from the seed-0 tree, at
    phase 10's batch, against the single-device eager step: loss within
    rel 1e-4, every leaf's gradient within MESH_TP_GRAD_REL of its norm, the
    updated parameters by MESH_TP_UPDATE_TOL; the data replicas bit-equal;
    a `remat=True` step against the plain mesh step. cuDNN deterministic,
    as phase 10."""
    import dataclasses
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.models import paraformer
    from toolbox_for_asr_and_tts_tpu_torch.ops.kernels import (
        fsmn_conv_dw as kdw)
    from toolbox_for_asr_and_tts_tpu_torch.parallel import trainstep as ts
    from toolbox_for_asr_and_tts_tpu_torch.parallel.sharding import (
        _flat_paths, make_2d_mesh, shard_params)
    from toolbox_for_asr_and_tts_tpu_torch.runtime.mesh import Sharded
    dev = torch.device("cuda", 0)
    mesh = make_2d_mesh(4, model_parallel=2, devices=[dev] * 4)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        def fresh():
            from toolbox_for_asr_and_tts_tpu_torch.models.convert import (
                tree_to)
            return tree_to(paraformer.init_params(
                cfg, torch.Generator().manual_seed(0)), dev)

        local = fresh()
        init_opt, step = ts.make_train_step(cfg, ts.adamw(FT_LR), device=dev)
        opt = init_opt(local)
        _, _, m_local = step(local, opt, batch)

        def mesh_step(c):
            sp = shard_params(fresh(), mesh)
            init, st = ts.make_train_step(c, ts.adamw(FT_LR), mesh=mesh)
            o = init(sp)
            torch.cuda.synchronize()
            kdw.launches = 0
            t0 = time.perf_counter()
            (_, _, m), k1n, k2n = counted(torch, lambda: st(sp, o, batch))
            return sp, m, (k1n, kdw.launches), time.perf_counter() - t0
        sp, m, launches, wall_s = mesh_step(cfg)
        sp_r, m_r, launches_r, wall_r = mesh_step(
            dataclasses.replace(cfg, remat=True))
        l_local, l_mesh = m_local["loss"].item(), m["loss"].item()
        rel = abs(l_mesh - l_local) / abs(l_local)
        require(rel <= 1e-4, f"dp + tp loss {l_mesh} vs {l_local}")
        paths = [p for p, _ in _flat_paths(sp)]
        leaves_sp = ts.param_leaves(sp)
        leaves_local = ts.param_leaves(local)
        g_rel, n_off, n_all, worst_p = {}, 0, 0, 0.0
        for path, a, b in zip(paths, leaves_sp, leaves_local):
            g = Sharded([t.grad if t.grad is not None else torch.zeros_like(t)
                         for t in a.shards], a.sharding).gather()
            g_rel[path] = ((g - b.grad).norm()
                           / b.grad.norm().clamp_min(1e-30)).item()
            d = (a.gather() - b.detach()).abs()
            worst_p = max(worst_p, d.max().item())
            n_off += int((d > MESH_TP_UPDATE_TOL).sum())
            n_all += d.numel()
        top = sorted(g_rel, key=g_rel.get, reverse=True)[:4]
        worst_g = g_rel[top[0]]
        print("mesh (f) worst gradient leaves |dg| / |g|: " + ", ".join(
            f"{p} {g_rel[p]:.3g}" for p in top), flush=True)
        n_data = mesh.shape["data"]
        for leaf in leaves_sp:
            k = len(leaf.shards) // n_data
            for dd in range(1, n_data):
                require(all(torch.equal(x, y) for x, y in zip(
                    leaf.shards[:k], leaf.shards[dd * k:(dd + 1) * k])),
                    "dp + tp: data replicas differ")
        remat_equal = all(torch.equal(x, y) for a, b in zip(
            leaves_sp, ts.param_leaves(sp_r)) for x, y in zip(a.shards,
                                                               b.shards))
        remat_d = max((x - y).abs().max().item() for a, b in zip(
            leaves_sp, ts.param_leaves(sp_r)) for x, y in zip(a.shards,
                                                               b.shards))
        loss_eq = m_r["loss"].item() == l_mesh
        layers = cfg.encoder_layers + cfg.decoder_layers
        print(f"mesh (f) dp + tp step on {mesh.shape} of cuda:0: loss "
              f"{l_mesh:.6f} vs single-device {l_local:.6f} (rel {rel:.3g}, "
              f"tol 1e-4), worst leaf |dg| / |g| {worst_g:.3g} (tol "
              f"{MESH_TP_GRAD_REL}), updated params max|d| {worst_p:.3g} (tol "
              f"2 lr), {n_off} of {n_all} elements past "
              f"{MESH_TP_UPDATE_TOL}; data replicas bit-equal; remat step "
              f"{'bit-equal' if remat_equal else f'max|d| {remat_d:.3g}'} to "
              f"the plain one (loss {'equal' if loss_eq else 'differs'}); "
              f"K1 / backward {launches} per step, remat {launches_r}; "
              f"step {wall_s:.2f} s, remat {wall_r:.2f} s ({card})",
              flush=True)
        require(worst_g <= MESH_TP_GRAD_REL, f"dp + tp gradient rel "
                                             f"{worst_g}")
        require(worst_p <= 2 * FT_LR, f"dp + tp update max|d| {worst_p}")
        require(n_off <= 1e-3 * n_all, f"dp + tp: {n_off} of {n_all} "
                f"elements off by more than {MESH_TP_UPDATE_TOL}")
        require(remat_d <= MESH_TP_UPDATE_TOL, f"remat step max|d| {remat_d}")
        require(launches == (layers * n_data, layers * n_data),
                f"dp + tp K1 / backward {launches}")
        require(launches_r == ((layers + cfg.encoder_layers) * n_data,
                               layers * n_data),
                f"remat K1 / backward {launches_r}")
        return dict(mesh=mesh.shape, loss=l_mesh, loss_local=l_local,
                    loss_rel=rel, grad_rel=worst_g, grad_rel_leaf=top[0],
                    update_max_abs=worst_p,
                    update_off=n_off, elements=n_all,
                    remat_bit_equal=remat_equal, remat_max_abs=remat_d,
                    remat_loss_equal=loss_eq, launches=list(launches),
                    launches_remat=list(launches_r), step_s=wall_s,
                    remat_step_s=wall_r)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def mesh_path(torch, card, peaks, floor_ms, reco, wavs, synth):
    """Phase 13: the multi-card layer at full width."""
    t_phase = time.perf_counter()
    n = torch.cuda.device_count()
    print(f"mesh phase: {n} card(s) visible; positions repeat cuda:0 where "
          "a mesh has more positions than cards", flush=True)
    out = dict(cards=n)
    out["transcribe"] = mesh_transcribe(torch, card, reco, wavs)
    out["ticker"] = mesh_ticker(torch, card, reco.params)
    out["synth"] = mesh_synth(torch, card, synth)
    out["seq_parallel"] = mesh_seq_parallel(torch, card, peaks, floor_ms,
                                            reco.params, reco.cfg, wavs)
    batch = mesh_batch(torch, reco.cfg, wavs, FT_K_MAX,
                       len(reco.tokenizer.tokens))
    out["pipeline"] = mesh_pipeline(torch, card, peaks, floor_ms,
                                    reco.params, reco.cfg, batch)
    out["train"] = mesh_train(torch, card, reco.cfg, batch)
    graph_snapshot("mesh")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"mesh phase: {out['phase_s']:.1f} s", flush=True)
    return out


def mesh_launches(mesh, k: str):
    """Phase 13's counts: each mesh transcribe's per position, and (K1)
    the sequence-parallel encode's and the pipeline's."""
    i = 0 if k == "k1" else 1
    out = dict(launches_mesh_per_position={
        name: [c[i] for c in run["per_position"]]
        for name, run in mesh["transcribe"].items()
        if isinstance(run, dict)})
    if k == "k1":
        out.update(launches_mesh_seq_parallel=mesh["seq_parallel"][
                       "k1_per_encode"],
                   launches_mesh_pipeline=mesh["pipeline"]["k1"],
                   launches_mesh_train_step=mesh["train"]["launches"][0])
    return out


def only_mesh(torch, card, peaks, floor_ms, at) -> int:
    """`--only-mesh`: phase 13 alone, over phase 3's recognizer and phase
    7's synthesizer built afresh; prints its JSON line and no result
    line."""
    from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import Recognizer
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer import (
        ParaformerConfig)
    from toolbox_for_asr_and_tts_tpu_torch.tts.synthesizer import Synthesizer
    try:
        at("phase 13: the mesh layer")
        reco = Recognizer.random(ParaformerConfig(), seed=0)
        synth = tts_pin(Synthesizer.random(seed=0, tiny=False))
        mesh = mesh_path(torch, card, peaks, floor_ms, reco, make_wavs(),
                         synth)
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps({"mesh": mesh, "card": card}))
    return 0


def only_train(torch, card, at, eager_only: bool = False) -> int:
    """`--only-train`: phase 10 alone on phase 3's rows; prints its JSON
    line and no result line. `--only-train-eager`: its eager steps alone
    (`finetune_path(eager_only=True)`)."""
    try:
        at("phase 10: fine-tuning")
        train = finetune_path(torch, card, make_wavs(), eager_only)
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps({"train": train, "card": card}))
    return 0


# ---------------------------------- phase 14: the remaining serving paths
PATHS_CAPACITY = 64
PATHS_SESSIONS = 16       # phase 4's S = 16 sessions (seed 116), each cut
PATHS_CHUNKS = 8          # to its first 8 chunks of 0.4 s (3.2 s)
PATHS_COMPARE = (0, 1)    # sessions held against an OnlineRecognizer
PATHS_EMBED_REL = 1e-3    # |d| <= this * max |x| per embedding (phase 13(a))
PATHS_BUSY_TICKS = 3      # profiled ticks for the card's busy share


def paths_audio():
    return [a[:PATHS_CHUNKS * CHUNK]
            for a in session_audio(PATHS_SESSIONS, seed=100 + PATHS_SESSIONS)]


def unfused_ticker(torch, card, params):
    """(a) `BatchedChunkedASR(capacity=64, fused=False)` on 16 sessions x 8
    chunks: K1 50 per step and K2 1 per fbank quantum call; sessions
    PATHS_COMPARE against a per-session `OnlineRecognizer` on the card
    (fired counts equal, embeddings within PATHS_EMBED_REL of each one's
    max |x|, the recognizer's first max_tokens); step and tick walls, the
    card's busy share of a tick."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.asr.tokenizer import CharTokenizer
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer import (
        ParaformerConfig)
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer_online import (
        OnlineConfig, OnlineRecognizer)
    from toolbox_for_asr_and_tts_tpu_torch.parallel.stream_batcher import (
        BatchedChunkedASR)
    cfg, ocfg = ParaformerConfig(), OnlineConfig()
    audios = paths_audio()
    asr = BatchedChunkedASR(params, cfg, ocfg, capacity=PATHS_CAPACITY,
                            fused=False)
    asr.warm()
    require(len(asr.programs) == 0 and len(asr.shared) == 0,
            "warm() built a program on the unfused ticker")
    # each step call's wall, from its inputs to the fetch of its outputs
    # (the program is built before the clock starts)
    step_walls, get = [], asr._unfused_fn

    def timed():
        prog = get()

        def call(*args, **kw):
            t0 = time.perf_counter()
            out = prog(*args, **kw)
            step_walls.append(time.perf_counter() - t0)
            return out
        return call
    asr._unfused_fn = timed
    steps0, fb0 = asr.steps, asr.fbanks
    (ticks, fired), k1n, k2n = counted(
        torch, lambda: feed_ticks(asr, audios, PATHS_CHUNKS))
    steps, fbanks = asr.steps - steps0, asr.fbanks - fb0
    require(steps > 0 and fbanks > 0, f"unfused: {steps} steps, {fbanks} "
                                      "fbank calls")
    require(k1n == cfg.encoder_layers * steps and k2n == fbanks,
            f"unfused: K1 {k1n} / K2 {k2n} launches over {steps} steps and "
            f"{fbanks} fbank calls")
    tokens = sum(len(v) for v in fired.values())
    require(tokens > 0, "the unfused ticker fired no token")
    require(all(np.isfinite(e).all() and e.shape == (cfg.d_model,)
                for v in fired.values() for e in v),
            "unfused embeddings not finite or not [d_model]")
    worst, compared = 0.0, []
    for i in PATHS_COMPARE:
        reco = OnlineRecognizer(params, cfg, CharTokenizer.dummy(
            cfg.vocab_size), ocfg)
        for c in range(PATHS_CHUNKS):
            reco.push_audio(audios[i][c * CHUNK:(c + 1) * CHUNK])
        want, got = reco._embeds, fired[i][:ocfg.max_tokens]
        require(len(got) == len(want), f"unfused session {i}: {len(got)} "
                f"fired, the recognizer {len(want)}")
        for a, b in zip(got, want):
            err = float(np.abs(a - b).max())
            scale = float(np.abs(b).max())
            require(err <= PATHS_EMBED_REL * scale,
                    f"unfused session {i}: embedding |d| {err} beyond "
                    f"{PATHS_EMBED_REL} of {scale}")
            worst = max(worst, err / scale)
        compared.append(len(want))
    step = wall_stats(step_walls[1:])    # the first replay apart
    busy, _ = busy_ticks(torch, asr, audios, PATHS_BUSY_TICKS)
    tick = tick_stats(ticks)
    return dict(sessions=PATHS_SESSIONS, chunks=PATHS_CHUNKS, steps=steps,
                fbank_calls=fbanks, fbank_captures=asr.shared.captures,
                k1_per_step=k1n / steps, k2_per_fbank=k2n / fbanks,
                tokens=tokens, compared_tokens=compared,
                max_rel_embed_err=worst, step=step,
                tick=tick, busy_ms_per_tick=busy / PATHS_BUSY_TICKS,
                busy_share=busy / PATHS_BUSY_TICKS / tick["median_ms"])


def unbucketed_ticker(torch, card, params):
    """(b) `BatchedChunkedASR(capacity=64, partials=True, bucketed=False)`
    and the bucketed ticker on the same 16 sessions, finalized: ids equal,
    K1 50 / K2 1 per step in both; walls and busy shares."""
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer import (
        ParaformerConfig)
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer_online import (
        OnlineConfig)
    from toolbox_for_asr_and_tts_tpu_torch.parallel.stream_batcher import (
        BatchedChunkedASR)
    cfg = ParaformerConfig()
    audios = paths_audio()
    out, got = {}, {}
    for name, bucketed in (("unbucketed", False), ("bucketed", True)):
        asr = BatchedChunkedASR(params, cfg, OnlineConfig(),
                                capacity=PATHS_CAPACITY, partials=True,
                                bucketed=bucketed)
        require(asr.bucketed is bucketed, f"{name}: bucketed={asr.bucketed}")
        t0 = time.perf_counter()
        asr.warm()
        warm_s = time.perf_counter() - t0
        if not bucketed:
            require(sorted(asr.programs) == [("tick", PATHS_CAPACITY)],
                    f"unbucketed programs {sorted(asr.programs)}")
        steps0 = asr.steps
        (ticks, ids, finals), k1n, k2n = counted(
            torch, lambda: drive_chunked(asr, audios))
        n = asr.steps - steps0
        require((k1n, k2n) == (cfg.encoder_layers * n, n),
                f"{name}: K1 / K2 {k1n} / {k2n} over {n} steps")
        busy, _ = busy_ticks(torch, asr, audios, PATHS_BUSY_TICKS)
        tick = tick_stats(ticks)
        got[name] = (ids, finals)
        out[name] = dict(steps=n, k1_per_step=k1n / n, k2_per_step=k2n / n,
                         programs=len(asr.programs), warm_s=warm_s,
                         step=step_stats(ticks)[1], tick=tick,
                         busy_ms_per_tick=busy / PATHS_BUSY_TICKS,
                         busy_share=busy / PATHS_BUSY_TICKS
                         / tick["median_ms"],
                         tokens=sum(len(v) for v in ids.values()),
                         final_tokens=sum(len(v) for v in finals.values()))
    require(got["unbucketed"] == got["bucketed"],
            "unbucketed ids differ from the bucketed ticker's")
    require(out["bucketed"]["tokens"] > 0, "no token fired")
    return out


def single_phase_tts(torch, card, synth):
    """(c) phase 7's synthesizer built under TTS_TWO_PHASE=0 beside a
    two-phase one on the same weights, both pinned as phase 7, on the
    14-segment paragraph: per batch (one phone group each) no probe and
    one synthesis, sample counts equal to two-phase's, PCM within
    TTS_PCM_LSB where two-phase's t_mel was t_cap; walls and pools."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.tts.synthesizer import Synthesizer
    saved = os.environ.get("TTS_TWO_PHASE")
    os.environ["TTS_TWO_PHASE"] = "0"
    try:
        single = tts_pin(Synthesizer(synth.ap, synth.acfg, synth.vp,
                                     synth.vcfg, device="cuda"))
    finally:
        if saved is None:
            del os.environ["TTS_TWO_PHASE"]
        else:
            os.environ["TTS_TWO_PHASE"] = saved
    two = tts_pin(Synthesizer(synth.ap, synth.acfg, synth.vp, synth.vcfg,
                              device="cuda"))
    require(not single.two_phase and two.two_phase,
            f"two_phase {single.two_phase} / {two.two_phase}")
    segments = tts_segments(synth)
    bs = synth.cfg.batch_size
    groups = [segments[i:i + bs] for i in range(0, len(segments), bs)]
    rows, covered, other_lsb = [], 0, 0
    for g in groups:
        (w2, _), n2 = tts_counted(torch, two, lambda: two.synthesize_segments(
            g, MOUNT_VOICE))
        (w1, _), n1 = tts_counted(torch, single,
                                  lambda: single.synthesize_segments(
                                      g, MOUNT_VOICE))
        require((n1["probes"], n1["synths"], n1["k1"], n1["k2"])
                == (0, 1, 0, 0), f"single-phase programs {n1}")
        require((n2["probes"], n2["synths"]) == (1, 1),
                f"two-phase programs {n2}")
        require([len(w) for w in w1] == [len(w) for w in w2],
                "single-phase sample counts differ from two-phase's")
        require(all(np.isfinite(w).all() for w in w1), "samples not finite")
        t_two, t_cap = n2["mel_frames"] // len(g), n1["mel_frames"] // len(g)
        lsb = max(int(np.abs(pcm16(a) - pcm16(b)).max())
                  for a, b in zip(w1, w2))
        if t_two == t_cap:
            require(lsb <= TTS_PCM_LSB, f"single vs two-phase at t_mel "
                                        f"{t_cap}: PCM differs by {lsb} LSB")
            covered += 1
        else:
            other_lsb = max(other_lsb, lsb)
        rows.append(dict(segments=len(g), t_mel_two_phase=t_two,
                         t_cap=t_cap, lsb=lsb))

    def walls(s):
        s.synthesize(TTS_TEXT)
        out = []
        for _ in range(3):
            t0 = time.perf_counter()
            res, n = tts_counted(torch, s, lambda: s.synthesize(TTS_TEXT))
            out.append((time.perf_counter() - t0) * 1e3)
            check_tts(s, res, segments)
        return statistics.median(out), n
    single_ms, n1 = walls(single)
    two_ms, n2 = walls(two)
    require(n1["probes"] == 0 and n1["synths"] == len(groups),
            f"single-phase synthesize ran {n1}")
    return dict(groups=rows, covered=covered, other_max_lsb=other_lsb,
                wall_ms=single_ms, two_phase_wall_ms=two_ms,
                mel_frames=n1["mel_frames"],
                two_phase_mel_frames=n2["mel_frames"],
                pool_bytes=single.programs.pool_bytes(),
                two_phase_pool_bytes=two.programs.pool_bytes())


def paths_path(torch, card, params, synth, s16=None, tts7=None):
    """Phase 14: the reference's remaining serving paths at full width;
    `s16` is phase 4's S = 16 row and `tts7` phase 7's line (None when the
    phase runs alone)."""
    t_phase = time.perf_counter()
    unfused = unfused_ticker(torch, card, params)
    unbucketed = unbucketed_ticker(torch, card, params)
    fused = dict(phase14=unbucketed["bucketed"])
    if s16 is not None:
        fused.update(phase4_step=s16["step_all_live"],
                     phase4_tick=s16["tick_all_live"])
    u, b = unfused, unbucketed["bucketed"]
    print(f"streaming unfused (capacity {PATHS_CAPACITY}, "
          f"{PATHS_SESSIONS} sessions x {PATHS_CHUNKS} chunks): "
          f"{u['steps']} steps, {u['fbank_calls']} fbank calls "
          f"({u['fbank_captures']} captured), K1 {u['k1_per_step']:g}/step, "
          f"K2 {u['k2_per_fbank']:g}/fbank call; step median "
          f"{u['step']['median_ms']:.2f} ms, p95 {u['step']['p95_ms']:.2f}; "
          f"tick median {u['tick']['median_ms']:.2f} ms, p95 "
          f"{u['tick']['p95_ms']:.2f}; busy {u['busy_ms_per_tick']:.2f} "
          f"ms/tick, share {u['busy_share']:.3f}; sessions "
          f"{list(PATHS_COMPARE)} = OnlineRecognizer ({u['compared_tokens']} "
          f"tokens, max rel |d| {u['max_rel_embed_err']:.3g}) | fused "
          f"(bucketed, same sessions): step median "
          f"{b['step']['median_ms']:.2f} ms, p95 {b['step']['p95_ms']:.2f}; "
          f"tick median {b['tick']['median_ms']:.2f} ms, p95 "
          f"{b['tick']['p95_ms']:.2f}; busy share {b['busy_share']:.3f}"
          + ("" if s16 is None else
             f" | phase 4 S=16 all live: step median "
             f"{s16['step_all_live']['median_ms']:.2f} ms, p95 "
             f"{s16['step_all_live']['p95_ms']:.2f}; tick median "
             f"{s16['tick_all_live']['median_ms']:.2f} ms, p95 "
             f"{s16['tick_all_live']['p95_ms']:.2f}")
          + f" on {card}", flush=True)
    f = unbucketed["unbucketed"]
    print(f"streaming unbucketed (partials, finalized): ids equal to the "
          f"bucketed ticker's ({f['tokens']} + {f['final_tokens']} tokens); "
          f"{f['steps']} steps ({b['steps']} bucketed), K1 "
          f"{f['k1_per_step']:g} / K2 {f['k2_per_step']:g} per step; "
          f"{f['programs']} program (warm {f['warm_s']:.1f} s, bucketed "
          f"{b['programs']} in {b['warm_s']:.1f} s); tick median "
          f"{f['tick']['median_ms']:.2f} ms ({b['tick']['median_ms']:.2f} "
          f"bucketed), busy share {f['busy_share']:.3f} on {card}",
          flush=True)
    tts = single_phase_tts(torch, card, synth)
    print(f"tts single-phase (TTS_TWO_PHASE=0): {len(tts['groups'])} phone "
          f"groups, 0 probes, one synthesis each; t_mel two-phase / cap "
          f"{[(r['t_mel_two_phase'], r['t_cap']) for r in tts['groups']]}; "
          f"sample counts equal; PCM within {TTS_PCM_LSB} LSB in "
          f"{tts['covered']} group(s) at the cap (max |d| "
          f"{[r['lsb'] for r in tts['groups']]} LSB), max |d| elsewhere "
          f"{tts['other_max_lsb']} LSB; synthesize wall {tts['wall_ms']:.1f} "
          f"ms (two-phase {tts['two_phase_wall_ms']:.1f}"
          + ("" if tts7 is None else
             f", phase 7 {tts7['one_shot']['wall_ms']:.1f}")
          + f"), mel frames {tts['mel_frames']} ({tts['two_phase_mel_frames']}"
          f"), graph pool {tts['pool_bytes']} bytes (two-phase "
          f"{tts['two_phase_pool_bytes']}) on {card}", flush=True)
    graph_snapshot("paths")
    out = dict(unfused=unfused, unbucketed=unbucketed["unbucketed"],
               fused=fused, tts=tts)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"paths phase: {out['phase_s']:.1f} s", flush=True)
    return out


def only_paths(torch, card, peaks, at) -> int:
    """`--only-paths`: K2 at the unfused quantum, then phase 14 alone over
    phase 3's weights and phase 7's synthesizer built afresh; prints its
    JSON line and no result line."""
    from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import Recognizer
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer import (
        ParaformerConfig)
    from toolbox_for_asr_and_tts_tpu_torch.tts.synthesizer import Synthesizer
    try:
        row = check_k2(torch, peaks, STREAM_S, 4080, 24,
                       "stream_unfused_quantum")
        at("phase 14: the remaining serving paths")
        reco = Recognizer.random(ParaformerConfig(), seed=0)
        synth = tts_pin(Synthesizer.random(seed=0, tiny=False))
        paths = paths_path(torch, card, reco.params, synth)
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps({"paths": paths, "k2_row": row, "card": card}))
    return 0


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
    t_start = time.perf_counter()

    def at(what):
        print(f"[{time.perf_counter() - t_start:.1f} s] {what}", flush=True)
    try:
        card = card_line()
        print(card, flush=True)       # name, power limit: as nvidia-smi says
        kind = torch.cuda.get_device_name(0)
        peaks = card_peaks(kind)
        print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"cuda {torch.version.cuda}; peaks used for bounds: "
              f"{peaks[0] / 1e12} TB/s, {peaks[1] / 1e12} TFLOP/s f32, "
              f"{peaks[2] / 1e12} TOP/s int8 (tensor cores)",
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
        if "--only-mesh" in argv:
            return only_mesh(torch, card, peaks, floor_ms, at)
        if "--only-paths" in argv:
            return only_paths(torch, card, peaks, at)
        if "--only-train" in argv or "--only-train-eager" in argv:
            return only_train(torch, card, at, "--only-train-eager" in argv)
        k1_rows = check_k1(torch, peaks, floor_ms)
        k1_backward = check_k1_backward(torch, peaks, floor_ms)
        if "--sweep" in argv:
            sweep_k1(torch)
            sweep_dw(torch)
        k2_row = check_k2(torch, peaks)
        k1_stream, k2_stream = check_streaming_kernels(torch, peaks, floor_ms)
        k1_service, k2_service = check_service_kernels(torch, peaks, floor_ms)
        at("phase 3: the main path")
        reco, wavs, launches, rtf = main_path(torch, card, profile)
        compare_cpu(torch, reco, wavs)
        at("phase 4: the streaming path")
        streaming, compare_ids, compare_audio = streaming_path(
            torch, card, reco.params, profile)
        streaming["card_vs_cpu"] = compare_streaming(
            torch, reco.params, compare_ids, compare_audio)
        at("phase 6: the voice service")
        service, models = service_path(torch, card, reco, profile)
        at("phase 7: TTS")
        tts, synth = tts_path(torch, card, profile)
        at("phase 8: mounted checkpoints")
        root = tempfile.mkdtemp(prefix="mounted-damo-")
        mounted = None
        try:
            # phases 8-9 serve at phase 6's 64 hub rows (the profile's
            # capacity is phase 12's to measure); their children inherit it
            os.environ["VOICE_BATCH_CAPACITY"] = "64"
            try:
                checkpoints, mounted = checkpoints_path(
                    torch, card, root, reco, wavs, models, synth, profile)
                at("phase 9: the entry points")
                entry_points = entry_points_path(
                    torch, card, root, mounted, tts_segments(synth)[0],
                    checkpoints["tts"]["samples"])
            finally:
                del os.environ["VOICE_BATCH_CAPACITY"]
                if mounted is not None:
                    mounted[0].stop()
            at("phase 10: fine-tuning")
            train = finetune_path(torch, card, wavs)
            at("phase 11: reduced precision")
            precision = precision_path(torch, card, peaks, reco, wavs, synth)
            at("phase 12: the dispatch profile and the rehearsal")
            dispatch = dispatch_path(torch, card, reco, synth, root,
                                     checkpoints["service"]["rest_text"])
        finally:
            shutil.rmtree(root, ignore_errors=True)
        at("phase 13: the mesh layer")
        mesh = mesh_path(torch, card, peaks, floor_ms, reco, wavs, synth)
        at("phase 14: the remaining serving paths")
        paths = paths_path(torch, card, reco.params, synth, streaming["S16"],
                           tts)
        streaming["unfused_vs_fused"] = dict(
            unfused=paths["unfused"], fused=paths["fused"],
            unbucketed=paths["unbucketed"])
        tts["single_phase"] = dict(paths["tts"],
                                   phase7_wall_ms=tts["one_shot"]["wall_ms"])
    except Exception:   # every phase failure ends the run without a result
        traceback.print_exc()
        return 1
    at("all phases passed")

    main_k1 = next(r for r in k1_rows
                   if r["site"] == "encoder" and r["dtype"] == "float32")
    main_bwd = next(r for r in k1_backward
                    if r["site"] == "encoder" and r["dtype"] == "float32")
    per_step = train["launches_per_step"]
    captured = train["captured"]

    def in_train_replay(k):
        """ms per launch inside a replayed training step (profiler)."""
        row = captured["profile"].get(k)
        return None if row is None else row["us_per_launch"] / 1e3
    served = {run: service[run]["launches"]
              for run in ("S1", "S16_first", "S16_unpipelined", "S16",
                          "four_modes", "rest")}
    in_replay = launches["in_replay"]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "call_ms")

    def dispatch_launches(k):
        """Phase 12's counts: per chunked step of the capacity sweep, per
        transcribe and chunked step of the int16 upload, and the
        rehearsal's REST drive."""
        rows = dispatch["capacity"]["rows"]
        i16 = dispatch["int16"]
        return dict(
            launches_per_chunked_step_sweep={
                c: r[f"{k}_per_step"] for c, r in rows.items()},
            launches_per_transcribe_int16=i16["int16"][
                f"{k}_per_transcribe"],
            launches_per_chunked_step_int16=i16["chunked_int16"][
                f"{k}_per_step"],
            launches_rehearsal_rest=dispatch["rehearsal"]["rest_launches"][k])

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
             ms_in_replay=in_replay.get("fsmn_conv"),
             ms_in_step_replay=streaming["S64"].get("profile", {}).get(
                 "in_replay", {}).get("fsmn_conv"),
             launches_per_train_step=per_step["fsmn_conv"],
             launches_per_captured_train_step=captured["tally"]["fsmn_conv"],
             ms_in_train_step_replay=in_train_replay("fsmn_conv"),
             launches_bf16=precision["bf16"]["k1_per_transcribe"],
             launches_int8=precision["int8"]["k1_per_transcribe"],
             launches_per_chunked_step_int8={
                 s: r["k1_per_step"]
                 for s, r in precision["int8_streaming"].items()},
             **dispatch_launches("k1"),
             **mesh_launches(mesh, "k1"),
             launches_per_unfused_step=paths["unfused"]["k1_per_step"],
             launches_per_unbucketed_step=paths["unbucketed"]["k1_per_step"],
             shapes=k1_rows + k1_stream + k1_service + [
                 mesh["seq_parallel"]["k1_row"],
                 mesh["pipeline"]["k1_row"]]),
        dict(name="fsmn_conv_dw", route="cuda",
             source="toolbox_for_asr_and_tts_tpu_torch/csrc/fsmn_conv_dw.cu",
             replaces="toolbox_for_asr_and_tts_tpu/ops/pallas/fsmn_conv.py:38",
             launches=per_step["fsmn_conv_dw"],
             **{k: main_bwd[k] for k in keys},
             dw_only_ms=main_bwd["dw_only_ms"],
             dw_only_bound_ms=main_bwd["dw_only_bound_ms"],
             launch_floor_ms=main_bwd["launch_floor_ms"],
             launches_per_train_step=per_step["fsmn_conv_dw"],
             launches_per_captured_train_step=captured["tally"][
                 "fsmn_conv_dw"],
             ms_in_train_step_replay=in_train_replay("fsmn_conv_dw"),
             deterministic=main_bwd["deterministic"],
             replay_equal=main_bwd["replay_equal"],
             replay_ms=main_bwd["replay_ms"],
             dx_by_k1_plus_dw_only_ms=main_bwd["dx_by_k1_plus_dw_only_ms"],
             launches_mesh_pipeline=mesh["pipeline"]["k1_backward"],
             launches_mesh_train_step=mesh["train"]["launches"][1],
             shapes=k1_backward + [mesh["pipeline"]["k1_backward_row"]]),
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
             ms_in_replay=in_replay.get("frame_window"),
             ms_in_step_replay=streaming["S64"].get("profile", {}).get(
                 "in_replay", {}).get("frame_window"),
             launches_per_train_step=per_step["frame_window"],
             launches_bf16=precision["bf16"]["k2_per_transcribe"],
             launches_int8=precision["int8"]["k2_per_transcribe"],
             launches_per_chunked_step_int8={
                 s: r["k2_per_step"]
                 for s, r in precision["int8_streaming"].items()},
             **dispatch_launches("k2"),
             **mesh_launches(mesh, "k2"),
             launches_per_unfused_fbank=paths["unfused"]["k2_per_fbank"],
             launches_per_unbucketed_step=paths["unbucketed"]["k2_per_step"],
             shapes=[k2_row] + k2_stream + k2_service),
    ]
    graph_snapshot("end")
    print(json.dumps({"rtf_batch8": rtf, "card": card}))
    print(json.dumps({"streaming": streaming, "card": card}))
    print(json.dumps({"service": service, "card": card}))
    print(json.dumps({"tts": tts, "card": card}))
    print(json.dumps({"checkpoints": checkpoints}))
    print(json.dumps({"entry_points": entry_points}, ensure_ascii=False))
    print(json.dumps({"graphs": graphs_line()}))
    print(json.dumps({"train": train, "card": card}))
    print(json.dumps({"precision": precision, "card": card}))
    print(json.dumps({"dispatch": dispatch, "card": card}))
    print(json.dumps({"mesh": mesh, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
