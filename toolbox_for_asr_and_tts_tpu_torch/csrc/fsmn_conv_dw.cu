// Weight gradient of the FSMN memory block (kernel K1, csrc/fsmn_conv.cu).
// sm_90a, plain C entry points for ctypes (ops/kernels/fsmn_conv_dw.py).
//
//   gm[b,t,d] = g[b,t,d] * mask[b,t]        xm[b,t,d] = x[b,t,d] * mask[b,t]
//   dw[d,j]   = sum_{b,t} gm[b,t,d] * xm[b, t + j - pad_l, d]
//
// with xm zero outside [0, T) (mask optional): the gradient with respect to
// the taps w of y = (xm + sum_j w[d,j] * xm[t + j - pad_l]) * mask, for an
// incoming gradient g of y. The TPU kernel it sits beside
// (toolbox_for_asr_and_tts_tpu/ops/pallas/fsmn_conv.py::fsmn_depthwise) has
// no backward: off the TPU the reference differentiates its XLA conv. The
// port needs this kernel because its K1 runs wherever the reference's
// differentiable `fsmn_block` runs. (The gradient for x is K1 itself, with
// the taps reversed and the pads swapped.)
//
// What bounds it on an H100: bytes. At the Paraformer encoder's shape (8 x
// 167 x 512, K 11, f32) a call must read g and x once, 2 x 2.74 MB, 1.6 us
// at the HBM rate, against 15 Mflop. The design, simple first:
//
// - pass 1: a block of 32 channels (one warp along D) and one thread row
//   per tap (8 to 16 rows; more taps take several passes) covers
//   `frames` frames of one batch row. Its threads stage those frames of gm
//   and the frames plus K - 1 halo rows of xm in shared memory as f32
//   (masked, zero outside [0, T)), x and g read in place at their own
//   (batch, frame) strides with unit channel stride, so the V third of
//   SAN-M's qkv product needs no copy; each thread issues all its loads
//   before its first store. Then each thread sums its channel's tap over
//   the block's frames, in frame order, and writes one partial to a
//   scratch [n_blocks, K, D] (n_blocks = B * frame blocks);
// - pass 2: a block per (32 channels, tap); 8 thread rows each add every
//   8th partial in block order, then row 0 adds the 8 sums in row order
//   and writes dw [D, K] in f32.
//
// No atomics: every sum has a fixed order, so two runs give the same bits.
//
// Pass 1 streams x and g with 4-byte loads at about 0.65 TB/s, where K1's
// forward reaches 1.7 TB/s with 16-byte ones (PERF.md has the times and
// what else was tried): 16-byte staging is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int CHANNELS = 32;        // channels per block of pass 1
constexpr int MAX_ROWS = 16;        // thread rows (taps in flight) per block
constexpr int MIN_ROWS = 8;
constexpr int REDUCE_ROWS = 8;      // thread rows of pass 2
constexpr int STAGE = 8;            // tile rows a thread loads per round trip
constexpr size_t SMEM_DEFAULT = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Shared memory, f32: xm rows [frames + k - 1][CHANNELS], gm rows
// [frames][CHANNELS].
size_t smem_bytes(int frames, int k) {
  return (2 * static_cast<size_t>(frames) + k - 1) * CHANNELS * sizeof(float);
}

// Stage the tile of one block: shared row r < rows is xm at frame
// t0 - pad_l + r, row rows + f is gm at frame t0 + f (zero outside [0, T)
// and for channels past D). A thread issues the loads of STAGE rows before
// it stores any: one round trip for the whole tile when STAGE * blockDim.y
// rows cover it.
template <typename T>
__device__ __forceinline__ void stage_tile(float* smem, const T* xb, const T* gb,
                                           const float* mb, bool c_in, int rows,
                                           int frames, int t0, int pad_l, int n_t,
                                           long long sxt, long long sgt) {
  const int tx = threadIdx.x, ty = threadIdx.y, ny = blockDim.y;
  const int total = rows + frames;
  for (int r0 = ty; r0 < total; r0 += STAGE * ny) {
    float v[STAGE];
#pragma unroll
    for (int i = 0; i < STAGE; ++i) {
      const int r = r0 + i * ny;
      const bool is_x = r < rows;
      const int t = is_x ? t0 - pad_l + r : t0 + r - rows;
      v[i] = 0.f;
      if (c_in && r < total && t >= 0 && t < n_t) {
        v[i] = to_f32(is_x ? xb[t * sxt] : gb[t * sgt]);
        if (mb != nullptr) v[i] = __fmul_rn(v[i], __ldg(mb + t));
      }
    }
#pragma unroll
    for (int i = 0; i < STAGE; ++i)
      if (r0 + i * ny < total) smem[(r0 + i * ny) * CHANNELS + tx] = v[i];
  }
}

// Pass 1: thread row ty sums taps ty, ty + blockDim.y, ... of its channel
// over the block's frames, one tap at a time, in frame order.
template <typename T>
__global__ void __launch_bounds__(CHANNELS * MAX_ROWS)
    fsmn_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                           const float* __restrict__ mask, float* __restrict__ partial,
                           int n_t, int n_d, long long sxb, long long sxt, long long sgb,
                           long long sgt, int k, int pad_l, int frames) {
  extern __shared__ __align__(16) float smem[];
  const int rows = frames + k - 1;
  const float* xs = smem;                                          // rows x CHANNELS
  const float* gs = smem + static_cast<size_t>(rows) * CHANNELS;   // frames x CHANNELS
  const int tx = threadIdx.x, ty = threadIdx.y, ny = blockDim.y;
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * frames;
  const int c = blockIdx.x * CHANNELS + tx;
  const bool c_in = c < n_d;
  const float* mb = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * n_t;
  stage_tile<T>(smem, x + b * sxb + c, g + b * sgb + c, mb, c_in, rows, frames, t0, pad_l,
                n_t, sxt, sgt);
  __syncthreads();
  if (!c_in) return;

  // tap j of frame t0 + f reads xm row f + j of the tile
  const int n_f = min(frames, n_t - t0);
  float* pb = partial + (static_cast<size_t>(b) * gridDim.y + blockIdx.y) * k * n_d + c;
  for (int j = ty; j < k; j += ny) {
    const float* xr = xs + j * CHANNELS + tx;
    const float* gr = gs + tx;
    float acc = 0.f;
#pragma unroll 8
    for (int f = 0; f < n_f; ++f) acc = fmaf(gr[f * CHANNELS], xr[f * CHANNELS], acc);
    pb[static_cast<size_t>(j) * n_d] = acc;
  }
}

// dw[c, j] = sum over r (in order) of sum over p = r, r + 8, ... (in
// order) of partial[p, j, c]: a fixed order, whatever the scheduling
__global__ void __launch_bounds__(CHANNELS * REDUCE_ROWS)
    fsmn_dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                          int n_blocks, int n_d, int k) {
  __shared__ float sums[REDUCE_ROWS][CHANNELS];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * CHANNELS + tx, j = blockIdx.y;
  const size_t n = static_cast<size_t>(k) * n_d;
  float s = 0.f;
  if (c < n_d) {
    const float* p = partial + static_cast<size_t>(j) * n_d + c;
#pragma unroll 4
    for (int q = ty; q < n_blocks; q += REDUCE_ROWS) s += p[q * n];
  }
  sums[ty][tx] = s;
  __syncthreads();
  if (ty != 0 || c >= n_d) return;
  float t = sums[0][tx];
#pragma unroll
  for (int r = 1; r < REDUCE_ROWS; ++r) t += sums[r][tx];
  dw[static_cast<size_t>(c) * k + j] = t;
}

template <typename T>
int launch(const void* x, const void* g, const void* mask, void* partial, void* dw, int n_b,
           int n_t, int n_d, long long sxb, long long sxt, long long sgb, long long sgt, int k,
           int pad_l, int frames, void* stream) {
  if (n_b < 1 || n_t < 1 || n_d < 1 || k < 1 || frames < 1 || pad_l < 0 || pad_l > k - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // one thread row per tap, at least MIN_ROWS rows (the extra rows only
  // stage): a block of 32 threads took twice the time at K = 1
  const int passes = (k + MAX_ROWS - 1) / MAX_ROWS;
  const dim3 block(CHANNELS, std::max((k + passes - 1) / passes, MIN_ROWS));
  const int n_tb = (n_t + frames - 1) / frames;
  const dim3 grid((n_d + CHANNELS - 1) / CHANNELS, n_tb, n_b);
  const size_t smem = smem_bytes(frames, k);
  auto kernel = fsmn_dw_partial_kernel<T>;
  if (smem > SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, block, smem, s>>>(static_cast<const T*>(x), static_cast<const T*>(g),
                                   static_cast<const float*>(mask),
                                   static_cast<float*>(partial), n_t, n_d, sxb, sxt, sgb, sgt,
                                   k, pad_l, frames);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fsmn_dw_reduce_kernel<<<dim3((n_d + CHANNELS - 1) / CHANNELS, k), dim3(CHANNELS, REDUCE_ROWS),
                          0, s>>>(static_cast<const float*>(partial), static_cast<float*>(dw),
                                  n_b * n_tb, n_d, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, g: [B, T, D] at their own (batch, frame) strides in elements, unit
// channel stride, the same dtype; mask: [B, T] float32 contiguous or NULL;
// partial: f32 scratch of B * ceil(T / frames) * K * D; dw: [D, K] f32
// contiguous. Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int fsmn_conv_dw_f32(const void* x, const void* g, const void* mask, void* partial,
                                void* dw, int n_b, int n_t, int n_d, long long sxb,
                                long long sxt, long long sgb, long long sgt, int k, int pad_l,
                                int frames, void* stream) {
  return launch<float>(x, g, mask, partial, dw, n_b, n_t, n_d, sxb, sxt, sgb, sgt, k, pad_l,
                       frames, stream);
}

extern "C" int fsmn_conv_dw_bf16(const void* x, const void* g, const void* mask, void* partial,
                                 void* dw, int n_b, int n_t, int n_d, long long sxb,
                                 long long sxt, long long sgb, long long sgt, int k, int pad_l,
                                 int frames, void* stream) {
  return launch<__nv_bfloat16>(x, g, mask, partial, dw, n_b, n_t, n_d, sxb, sxt, sgb, sgt, k,
                               pad_l, frames, stream);
}
