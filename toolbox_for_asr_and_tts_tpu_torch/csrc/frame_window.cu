// fbank framing stage: overlapping frames, DC removal, pre-emphasis, window,
// zero-pad to n_fft. sm_90a, plain C entry point for ctypes
// (ops/kernels/frame_window.py).
//
//   s[i]   = audio[b, f*shift + i]          (0 past the end of the audio)
//   c[i]   = s[i] - mean(s)                  (if remove_dc)
//   e[i]   = c[i] - pre * c[max(i-1, 0)]     (kaldi: the first sample repeats)
//   out[b, f, i] = e[i] * window[i] for i < frame_len, 0 up to n_fft
//
// Replaces the TPU kernel
// toolbox_for_asr_and_tts_tpu/ops/pallas/frame_window.py::frame_window.
//
// Design: one block per (row, frame). The block stages the frame's samples
// in shared memory, reduces their sum with warp shuffles and one pass over
// the per-warp partials, then writes the n_fft-wide output row with
// consecutive threads on consecutive addresses. Element-wise arithmetic uses
// the round-to-nearest intrinsics in the plain version's order, so only the
// order of the mean's sum differs from it.
//
// Bound on an H100: bytes. The audio is read once (frames overlap, so the
// 2.5x re-reads hit L2) and the framed rows, n_fft floats per frame shift
// of audio (3.2x the audio at 512 / 160), are written once.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__global__ void frame_window_kernel(const float* __restrict__ audio,
                                    const float* __restrict__ window, float* __restrict__ out,
                                    int n_samples, int n_frames, int frame_len, int frame_shift,
                                    int n_fft, float preemph, int remove_dc) {
  extern __shared__ float s[];  // [frame_len]
  __shared__ float partial[THREADS / 32];
  const int f = blockIdx.x;
  const int b = blockIdx.y;
  const long long start = static_cast<long long>(f) * frame_shift;
  const float* row = audio + static_cast<size_t>(b) * n_samples;

  float sum = 0.f;
  for (int i = threadIdx.x; i < frame_len; i += THREADS) {
    const float v = start + i < n_samples ? row[start + i] : 0.f;
    s[i] = v;
    sum += v;
  }
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = sum;
  __syncthreads();
  float mean = 0.f;
  if (remove_dc) {
    float total = 0.f;
    for (int i = 0; i < THREADS / 32; ++i) total += partial[i];
    mean = total / static_cast<float>(frame_len);
  }

  float* dst = out + (static_cast<size_t>(b) * n_frames + f) * n_fft;
  for (int i = threadIdx.x; i < n_fft; i += THREADS) {
    float v = 0.f;
    if (i < frame_len) {
      float cur = __fsub_rn(s[i], mean);
      if (preemph != 0.f) {
        const float prev = __fsub_rn(s[i > 0 ? i - 1 : 0], mean);
        cur = __fsub_rn(cur, __fmul_rn(preemph, prev));
      }
      v = __fmul_rn(cur, window[i]);
    }
    dst[i] = v;
  }
}

}  // namespace

// audio: [B, n_samples] float32 contiguous; window: [frame_len] float32;
// out: [B, n_frames, n_fft] float32. Returns cudaGetLastError() after the
// launch.
extern "C" int frame_window_f32(const void* audio, const void* window, void* out, int n_b,
                                int n_samples, int n_frames, int frame_len, int frame_shift,
                                int n_fft, float preemph, int remove_dc, void* stream) {
  const dim3 grid(n_frames, n_b);
  const size_t smem = static_cast<size_t>(frame_len) * sizeof(float);
  frame_window_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const float*>(window),
      static_cast<float*>(out), n_samples, n_frames, frame_len, frame_shift, n_fft, preemph,
      remove_dc);
  return static_cast<int>(cudaGetLastError());
}
