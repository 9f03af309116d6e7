// FSMN memory block: depthwise conv over time plus residual, with the two
// validity-mask multiplies of `fsmn_block` fused in. sm_90a, plain C entry
// points for ctypes (ops/kernels/fsmn_conv.py).
//
//   xm[b,t,d] = x[b,t,d] * mask[b,t]                      (mask optional)
//   y[b,t,d]  = (xm[b,t,d] + sum_j w[d,j] * xm[b,t+j-pad_l,d]) * mask[b,t]
//
// with zero padding outside [0, T). Replaces the TPU kernel
// toolbox_for_asr_and_tts_tpu/ops/pallas/fsmn_conv.py::fsmn_depthwise.
//
// Design: one thread per output element. A block covers T_BLOCK frames x
// D_BLOCK channels; it stages the (T_BLOCK + K - 1) x D_BLOCK input tile
// (the halo of K - 1 frames included) and the K x D_BLOCK taps in shared
// memory, so each input element is read from device memory about
// (T_BLOCK + K - 1) / T_BLOCK times. Threads along x walk contiguous
// channels, so the loads and the store are coalesced. Products and sums use
// the round-to-nearest intrinsics in the order of the plain PyTorch version
// (residual first, then tap 0..K-1), so no FMA contraction separates the two.
//
// Bound on an H100: bytes. About 2*K flops per element against 8 bytes
// (f32 in and out), far below the card's flop:byte ratio.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int D_BLOCK = 32;  // channels per block: one warp across contiguous d
constexpr int T_BLOCK = 16;  // frames per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void fsmn_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                 const float* __restrict__ mask, T* __restrict__ y,
                                 int n_t, int n_d, int k, int pad_l) {
  extern __shared__ float smem[];
  float* tile = smem;                                // [T_BLOCK + k - 1][D_BLOCK]
  float* taps = smem + (T_BLOCK + k - 1) * D_BLOCK;  // [k][D_BLOCK]
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * T_BLOCK;
  const int d = blockIdx.x * D_BLOCK + tx;
  const size_t row0 = static_cast<size_t>(b) * n_t;

  for (int r = ty; r < T_BLOCK + k - 1; r += blockDim.y) {
    const int t = t0 - pad_l + r;
    float v = 0.f;
    if (t >= 0 && t < n_t && d < n_d) {
      v = to_f32(x[(row0 + t) * n_d + d]);
      if (mask != nullptr) v = __fmul_rn(v, mask[row0 + t]);
    }
    tile[r * D_BLOCK + tx] = v;
  }
  for (int j = ty; j < k; j += blockDim.y)
    taps[j * D_BLOCK + tx] = d < n_d ? to_f32(w[static_cast<size_t>(d) * k + j]) : 0.f;
  __syncthreads();

  const int t = t0 + ty;
  if (t >= n_t || d >= n_d) return;
  float acc = tile[(ty + pad_l) * D_BLOCK + tx];  // residual
  for (int j = 0; j < k; ++j)
    acc = __fadd_rn(acc, __fmul_rn(tile[(ty + j) * D_BLOCK + tx], taps[j * D_BLOCK + tx]));
  if (mask != nullptr) acc = __fmul_rn(acc, mask[row0 + t]);
  y[(row0 + t) * n_d + d] = from_f32<T>(acc);
}

template <typename T>
int launch(const void* x, const void* w, const void* mask, void* y, int n_b, int n_t,
           int n_d, int k, int pad_l, void* stream) {
  const dim3 block(D_BLOCK, T_BLOCK);
  const dim3 grid((n_d + D_BLOCK - 1) / D_BLOCK, (n_t + T_BLOCK - 1) / T_BLOCK, n_b);
  const size_t smem = static_cast<size_t>(T_BLOCK + 2 * k - 1) * D_BLOCK * sizeof(float);
  fsmn_conv_kernel<T><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(mask),
      static_cast<T*>(y), n_t, n_d, k, pad_l);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: [B, T, D] contiguous; w: [D, K] contiguous, x's dtype; mask: [B, T]
// float32 contiguous or NULL. Returns cudaGetLastError() after the launch.
extern "C" int fsmn_conv_f32(const void* x, const void* w, const void* mask, void* y,
                             int n_b, int n_t, int n_d, int k, int pad_l, void* stream) {
  return launch<float>(x, w, mask, y, n_b, n_t, n_d, k, pad_l, stream);
}

extern "C" int fsmn_conv_bf16(const void* x, const void* w, const void* mask, void* y,
                              int n_b, int n_t, int n_d, int k, int pad_l, void* stream) {
  return launch<__nv_bfloat16>(x, w, mask, y, n_b, n_t, n_d, k, pad_l, stream);
}
