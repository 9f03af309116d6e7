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
// What bounds it on an H100. At the Paraformer encoder's shape (8 x 167 x
// 512, K 11, f32) a call must move 5.5 MB, 1.6 us at the HBM rate; the
// data sit in L2, so a call costs the launch, one L2 round trip that
// reads x (L2 bandwidth), the sums (about 24 f32 instructions per output,
// and 29 bytes of shared-memory reads per output, the larger cost), and
// the stores draining. The design therefore:
//
// - reads x in place: x is addressed by (batch stride, frame stride) with
//   unit channel stride, so the V third of SAN-M's [B, T, 3D] qkv product
//   needs no copy; y is a new contiguous [B, T, D];
// - makes one round trip: a block of blockDim.x * blockDim.y threads
//   covers 4 * blockDim.x channels and F * blockDim.y frames. Its threads
//   issue their loads first, one 16-byte vector each (4 f32 or 8 bf16
//   channels) of the tile's rows (the block's frames and their K - 1 frame
//   halo, zero outside [0, T)) and of the block's taps (contiguous in w),
//   and each row's mask; then they store the tile as x * mask in f32, the
//   taps in f32 and the row masks to shared memory and meet at the one
//   barrier;
// - sums 4 channels x F frames per thread, one frame at a time: the taps
//   in registers (K = 11) or read from shared memory (any K), a window of
//   K rows in registers that slides one row per frame, and each frame
//   stored (16 bytes in f32, 8 in bf16) as soon as it is summed, so the
//   stores drain under the next frames' sums;
// - keeps the plain PyTorch version's roundings: products and sums use
//   the round-to-nearest intrinsics in its order (residual first, then
//   taps 0..K-1), so no FMA contraction separates the two and f32 results
//   are bit-equal to it;
// - skips the output mask multiply in a block whose rows all have mask 1
//   (x * 1 == x), found at the barrier (__syncthreads_and).
//
// K is a runtime argument; K = 11 (SAN-M) also has a compile-time
// instantiation. When x's base, strides or D do not allow 16-byte access,
// the wrapper launches the instantiation with 1 channel per thread and per
// load (the scalar path) of the same kernel. The wrapper picks the tile;
// PERF.md has the sweep behind its choice.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int MAX_THREADS = 256;    // per block, blockDim.x * blockDim.y
constexpr size_t SMEM_DEFAULT = 48 * 1024;

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

// 16 bytes holding 16 / sizeof(T) values of T -> f32.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& q, float* v) {
  if constexpr (std::is_same_v<T, float>) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

// VEC values to T in global memory: one 16-byte store (4 f32), one 8-byte
// store (4 bf16), or value by value (the scalar path).
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&v)[VEC]) {
  if constexpr (VEC == 4 && std::is_same_v<T, float>) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                              *reinterpret_cast<const unsigned*>(&hi));
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = from_f32<T>(v[i]);
  }
}

// CV f32 of shared memory (16-byte aligned when CV == 4).
template <int CV>
__device__ __forceinline__ void load_shared(const float* p, float (&v)[CV]) {
  if constexpr (CV == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < CV; ++e) v[e] = p[e];
  }
}

// The K = 11 taps of CV = 4 channels, as they lie in w (44 f32, 16-byte
// aligned) -> taps[j][e] = w[c + e, j].
template <int KC>
__device__ __forceinline__ void load_taps(const float* p, float (&taps)[KC][4]) {
  float flat[KC * 4];
#pragma unroll
  for (int i = 0; i < KC; ++i) {
    const float4 q = *reinterpret_cast<const float4*>(p + 4 * i);
    flat[4 * i] = q.x;
    flat[4 * i + 1] = q.y;
    flat[4 * i + 2] = q.z;
    flat[4 * i + 3] = q.w;
  }
#pragma unroll
  for (int j = 0; j < KC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) taps[j][e] = flat[e * KC + j];
}

struct Args {
  const void* x;
  const void* w;
  const float* mask;
  void* y;
  int n_b, n_t, n_d;
  long long stride_b, stride_t;  // x's strides in elements; channel stride 1
  int k, pad_l;
  int vec, frames, channels, threads_t, k_const;
  cudaStream_t stream;
};

// Shared memory, all f32: the tile [rows][channels] (rows = block_frames +
// k - 1), the row masks [rows], the block's taps [channels][k] as they lie
// in w.
size_t smem_bytes(int block_frames, int k, int channels) {
  const size_t rows = static_cast<size_t>(block_frames) + k - 1;
  return (rows * channels + (rows + 3) / 4 * 4 + static_cast<size_t>(channels) * k) *
         sizeof(float);
}

// LV: channels per load (16 bytes' worth, or 1 on the scalar path); CV:
// channels per thread in the sums and per store (4, or 1).
template <typename T, int CV, int F, int KC>
__global__ void __launch_bounds__(MAX_THREADS)
    fsmn_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ mask, T* __restrict__ y, int n_t, int n_d,
                     long long stride_b, long long stride_t, int k_arg, int pad_l) {
  constexpr int LV = CV == 1 ? 1 : 16 / sizeof(T);
  constexpr bool vector = LV * sizeof(T) == 16;
  using Raw = std::conditional_t<vector, uint4, T>;
  // tile rows one thread stages per batch: with at least K - 1 threads
  // along T, one batch (one round trip) stages the whole tile
  constexpr int BATCH = F * CV / LV + 2;
  const int k = KC > 0 ? KC : k_arg;
  const int n_x = blockDim.x, n_y = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * n_x + tx, n_threads = n_x * n_y;
  const int width = n_x * CV;            // channels of the block
  const int frames = n_y * F;            // output frames of the block
  const int rows = frames + k - 1;       // tile rows, halo included
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * frames;
  const int c0 = blockIdx.x * width;
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                                          // rows x width
  float* mask_s = smem + static_cast<size_t>(rows) * width;    // rows
  float* taps_s = mask_s + (rows + 3) / 4 * 4;                 // width x k

  // ---- one round trip. The staging threads: n_v 16-byte vectors per row.
  const int n_v = width / LV;
  const int sx = tid % n_v, sy = tid / n_v, row_step = n_threads / n_v;
  const int cs = c0 + sx * LV;           // the first channel this thread stages
  const bool cs_in = cs < n_d;           // LV divides D on the vector path
  const T* xs = x + b * stride_b + cs;
  const float* mb = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * n_t;
  // taps: w[c0 .. c0 + n_c, 0 .. k) is n_c * k contiguous values, copied as
  // they lie (the wrapper keeps w 16-byte aligned and `channels` a multiple
  // of 8, so wb is aligned); a tail shorter than 16 bytes value by value
  constexpr int TV = 16 / sizeof(T);
  const int n_taps = min(width, n_d - c0) * k;
  const T* wb = w + static_cast<size_t>(c0) * k;
  const int i_tap = tid * TV;
  uint4 tq = make_uint4(0, 0, 0, 0);
  if (i_tap + TV <= n_taps) tq = __ldg(reinterpret_cast<const uint4*>(wb + i_tap));

  int ones = 1;                          // every staged row has mask 1
  for (int r0 = sy; r0 < rows; r0 += BATCH * row_step) {
    Raw raw[BATCH];
    float m[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int t = t0 - pad_l + r0 + i * row_step;
      if (r0 + i * row_step < rows && t >= 0 && t < n_t && cs_in) {
        if constexpr (vector)
          raw[i] = __ldg(reinterpret_cast<const uint4*>(xs + t * stride_t));
        else
          raw[i] = xs[t * stride_t];
      } else {
        if constexpr (vector)
          raw[i] = make_uint4(0, 0, 0, 0);
        else
          raw[i] = from_f32<T>(0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int t = t0 - pad_l + r0 + i * row_step;
      m[i] = mb != nullptr && t >= 0 && t < n_t ? __ldg(mb + t) : 1.f;
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int r = r0 + i * row_step;
      if (r >= rows) break;
      float v[LV];
      if constexpr (vector)
        unpack<T>(raw[i], v);
      else
        v[0] = to_f32(raw[i]);
      if (mb != nullptr) {
#pragma unroll
        for (int e = 0; e < LV; ++e) v[e] = __fmul_rn(v[e], m[i]);
        ones &= m[i] == 1.f;
        if (sx == 0) mask_s[r] = m[i];
      }
      float* dst = tile + r * width + sx * LV;
#pragma unroll
      for (int e = 0; e < LV; e += 4) {
        if constexpr (LV >= 4)
          *reinterpret_cast<float4*>(dst + e) = make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
        else
          dst[e] = v[e];
      }
    }
  }
  if (i_tap + TV <= n_taps) {
    float v[TV];
    unpack<T>(tq, v);
#pragma unroll
    for (int e = 0; e < TV; e += 4)
      *reinterpret_cast<float4*>(taps_s + i_tap + e) = make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
  }
  // taps beyond one vector per thread, or a tail shorter than a vector
  for (int i = i_tap + TV <= n_taps ? i_tap + n_threads * TV : i_tap; i < n_taps;
       i += n_threads * TV)
    for (int e = 0; e < TV && i + e < n_taps; ++e) taps_s[i + e] = to_f32(wb[i + e]);
  const bool full = __syncthreads_and(ones);

  // ---- sums: CV channels from c, F frames from t0 + o0, one frame at a
  // time (taps inner), each frame stored as soon as it is summed
  const int c = c0 + tx * CV;
  const int o0 = ty * F;                 // block-local first output frame
  if (c >= n_d || t0 + o0 >= n_t) return;
  const float* col = tile + tx * CV;
  const float* my_taps = taps_s + static_cast<size_t>(tx) * CV * k;
  float taps[KC > 0 ? KC : 1][CV];       // taps[j][e] = w[c + e, j] (K = 11)
  float win[KC > 0 ? KC : 1][CV];        // rows o0 + f .. o0 + f + K - 1
  if constexpr (KC > 0) {
    load_taps<KC>(my_taps, taps);
#pragma unroll
    for (int j = 0; j + 1 < KC; ++j) load_shared<CV>(col + (o0 + j) * width, win[j + 1]);
  }
  // output frame o0 + f, in the plain version's order: residual, then taps
  // 0 .. K-1, then the mask; frames are summed in order (the window slides)
  auto frame = [&](int f, float (&a)[CV]) {
    load_shared<CV>(col + (o0 + f + pad_l) * width, a);
    if constexpr (KC > 0) {
#pragma unroll
      for (int j = 0; j + 1 < KC; ++j)
#pragma unroll
        for (int e = 0; e < CV; ++e) win[j][e] = win[j + 1][e];
      load_shared<CV>(col + (o0 + f + KC - 1) * width, win[KC - 1]);
#pragma unroll
      for (int j = 0; j < KC; ++j)
#pragma unroll
        for (int e = 0; e < CV; ++e) a[e] = __fadd_rn(a[e], __fmul_rn(win[j][e], taps[j][e]));
    } else {
      for (int j = 0; j < k; ++j) {
        float xr[CV];
        load_shared<CV>(col + (o0 + f + j) * width, xr);
#pragma unroll
        for (int e = 0; e < CV; ++e)
          a[e] = __fadd_rn(a[e], __fmul_rn(xr[e], my_taps[e * k + j]));
      }
    }
    if (!full) {
      const float mo = mask_s[o0 + f + pad_l];  // rows past T hold mask 1
#pragma unroll
      for (int e = 0; e < CV; ++e) a[e] = __fmul_rn(a[e], mo);
    }
  };

  T* yb = y + (static_cast<size_t>(b) * n_t + t0 + o0) * n_d + c;
  // every frame is summed (rows past T are zeros) and only stores are
  // predicated, so the unrolled frames interleave
#pragma unroll
  for (int f = 0; f < F; ++f) {
    float a[CV];
    frame(f, a);
    if (t0 + o0 + f < n_t) store_vec<T, CV>(yb + static_cast<size_t>(f) * n_d, a);
  }
}

template <typename T, int CV, int F, int KC>
int launch(const Args& a) {
  const int n_x = a.channels / CV;
  const dim3 block(n_x, a.threads_t);
  const int frames = a.threads_t * F;
  const dim3 grid((a.n_d + a.channels - 1) / a.channels, (a.n_t + frames - 1) / frames,
                  a.n_b);
  const size_t smem = smem_bytes(frames, a.k, a.channels);
  auto kernel = fsmn_conv_kernel<T, CV, F, KC>;
  if (smem > SMEM_DEFAULT) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, block, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w), a.mask, static_cast<T*>(a.y),
      a.n_t, a.n_d, a.stride_b, a.stride_t, a.k, a.pad_l);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CV, int F>
int by_k(const Args& a) {
  if (a.k_const == 0) return launch<T, CV, F, 0>(a);
  if constexpr (CV > 1)
    if (a.k_const == 11 && a.k == 11) return launch<T, CV, F, 11>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int CV>
int by_frames(const Args& a) {
  switch (a.frames) {
    case 2: return by_k<T, CV, 2>(a);
    case 4: return by_k<T, CV, 4>(a);
    case 8: return by_k<T, CV, 8>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(const Args& a) {
  const int cv = a.vec == 1 ? 1 : 4;
  if (a.channels % 8 != 0 || a.threads_t < 1 || (a.channels / cv) * a.threads_t > MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.vec == static_cast<int>(16 / sizeof(T))) return by_frames<T, 4>(a);
  if (a.vec == 1) return by_frames<T, 1>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

Args pack(const void* x, const void* w, const void* mask, void* y, int n_b, int n_t,
          int n_d, long long stride_b, long long stride_t, int k, int pad_l, int vec,
          int frames, int channels, int threads_t, int k_const, void* stream) {
  return Args{x,        w, static_cast<const float*>(mask), y, n_b, n_t, n_d, stride_b,
              stride_t, k, pad_l, vec, frames, channels, threads_t, k_const,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// x: [B, T, D] at (stride_b, stride_t, 1) elements; y: [B, T, D] contiguous;
// w: [D, K] contiguous, x's dtype, 16-byte aligned; mask: [B, T] float32
// contiguous or NULL. The tile: vec (16 / sizeof(T): the vector path, 4
// channels per thread; or 1: the scalar path, 1 channel per thread), frames
// per thread (2, 4 or 8), channels per block (a multiple of 8), threads_t
// (threads along T; at most 256 threads per block), k_const (0, or 11 for
// the K = 11 instantiation, vector path only).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a tile that has no instantiation.
extern "C" int fsmn_conv_f32(const void* x, const void* w, const void* mask, void* y,
                             int n_b, int n_t, int n_d, long long stride_b,
                             long long stride_t, int k, int pad_l, int vec, int frames,
                             int channels, int threads_t, int k_const, void* stream) {
  return dispatch<float>(pack(x, w, mask, y, n_b, n_t, n_d, stride_b, stride_t, k, pad_l,
                              vec, frames, channels, threads_t, k_const, stream));
}

extern "C" int fsmn_conv_bf16(const void* x, const void* w, const void* mask, void* y,
                              int n_b, int n_t, int n_d, long long stride_b,
                              long long stride_t, int k, int pad_l, int vec, int frames,
                              int channels, int threads_t, int k_const, void* stream) {
  return dispatch<__nv_bfloat16>(pack(x, w, mask, y, n_b, n_t, n_d, stride_b, stride_t, k,
                                      pad_l, vec, frames, channels, threads_t, k_const,
                                      stream));
}
