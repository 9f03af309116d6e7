// Backward of the FSMN memory block (kernel K1, csrc/fsmn_conv.cu): both
// gradients in one launch. sm_90a, plain C entry points for ctypes
// (ops/kernels/fsmn_conv_dw.py).
//
//   gm[b,t,d] = g[b,t,d] * mask[b,t]        xm[b,t,d] = x[b,t,d] * mask[b,t]
//   dx[b,t,d] = (gm[b,t,d] + sum_j w[d,K-1-j] * gm[b,t+j-pad_r,d]) * mask[b,t]
//   dw[d,j]   = sum_{b,t} gm[b,t,d] * xm[b,t+j-pad_l,d]
//
// with gm and xm zero outside [0, T) (mask optional): the gradients with
// respect to x and to the taps w of y = (xm + sum_j w[d,j] * xm[t+j-pad_l])
// * mask for an incoming gradient g of y. dx is K1 with the taps reversed
// and the pads swapped. The TPU kernel K1 replaces
// (toolbox_for_asr_and_tts_tpu/ops/pallas/fsmn_conv.py::fsmn_depthwise) has
// no backward: off the TPU the reference differentiates its XLA conv. The
// port needs this kernel because its K1 runs wherever the reference's
// differentiable `fsmn_block` runs.
//
// What bounds it on an H100: bytes. At the Paraformer encoder's shape (8 x
// 167 x 512, K 11, f32) a call must read x and g and write dx, 3 x 2.74 MB,
// 2.45 us at the HBM rate, against 30 Mflop (dw alone: 1.64 us). The data
// sit in L2, so a call costs the launch and a chain of dependent steps in
// each block: one round trip that stages the block's tile, the dw sums, dx,
// and the adding of the blocks' dw partials. The design, against that:
//
// - one staged tile feeds both gradients. A block covers a stripe of
//   `channels` channels, `threads_t * R` frames and one batch row. Before
//   its first sum it stages, as f32 in shared memory and masked, xm over
//   frames [t0 - pad_l, t0 + F + pad_r), gm over [t0 - pad_r, t0 + F +
//   pad_l) (over [t0, t0 + F) when dx is not wanted) and, for dx, the
//   block's taps (cp.async, 16 bytes at a time). Each thread issues the
//   16-byte loads (4 f32 or 8 bf16 channels, neighbouring threads on
//   neighbouring addresses) of up to BATCH tile rows before its first
//   store: one round trip for the tile at the main path's tiles. x and g
//   are read in place at their own (batch, frame) strides with unit channel
//   stride, so the V third of SAN-M's qkv product needs no copy. Where a
//   base, a stride or D is not a multiple of 16 bytes the wrapper launches
//   the scalar instantiation (1 channel per thread and per load);
// - dw and dx side by side: the block has two groups of threads_t thread
//   rows (whole warps), one for each gradient, over the same tiles, so the
//   two sums overlap instead of following each other (one group when dx is
//   not wanted);
// - dw from registers: a thread keeps the K tap sums of its 4 channels over
//   its R frames (unrolled) and a window of xm rows that slides one row per
//   frame, so each staged value leaves shared memory about once per thread.
//   K is taken in passes of KC taps (KC = 11 at K = 11, 8 for any other K
//   up to 128). The rows' sums are added in row order in shared memory
//   (a barrier of the dw group alone), and the block writes its
//   [K, channels] partial to a scratch [stripes, blocks, K, channels];
// - one kernel launch, deterministic, no float atomics: thread 0 publishes
//   the partial (__threadfence) and takes its stripe's integer ticket while
//   the dx group is still summing; the block that draws the last ticket
//   adds the stripe's partials in block order and writes dw [D, K] in f32,
//   so every sum has one order, whatever the scheduling. The tickets belong
//   to the call (they lie in its scratch) and are zeroed by a memset on the
//   launch stream just before the kernel, which a CUDA graph captures as a
//   memset node: calls and replays on any streams never share a ticket;
// - dx from the gm tile, 4 channels x R frames per thread, in the order of
//   the plain version fsmn_depthwise_plain(g, w.flip(-1), pad_r, pad_l,
//   mask): the residual first, then taps 0..K-1 with round-to-nearest
//   products and sums (no FMA contraction), then the mask, so f32 dx is
//   bit-equal to it. The taps are rounded to x's dtype as that call rounds
//   them. At K = 11 a window of K gm rows slides one row per frame in
//   registers beside the reversed taps; each frame is stored (16 bytes in
//   f32, 8 in bf16) into a new contiguous [B, T, D] as soon as it is summed.
//
// The wrapper picks the tile; PERF.md has the sweep behind its choice and
// the time of each step (fsmn_conv_bwd_steps_f32 below).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int MAX_THREADS = 384;     // per block, blockDim.x * blockDim.y (both groups)
constexpr int BATCH = 12;            // tile vectors a thread loads per round trip
constexpr int GENERIC_KC = 8;        // taps per pass of the any-K instantiation
constexpr int RED_BATCH = 16;        // partials a thread of the last block loads at once
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

// v rounded to T and back, as `w.to(x.dtype).float()` rounds the taps
template <typename T>
__device__ __forceinline__ float round_as(float v) {
  return to_f32(from_f32<T>(v));
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

// CV f32 from shared memory, or to it (16-byte aligned when CV == 4).
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

template <int CV>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[CV]) {
  if constexpr (CV == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < CV; ++e) p[e] = v[e];
  }
}

// CV f32 written by other blocks: through L2, never a stale L1 line.
template <int CV>
__device__ __forceinline__ void load_cg(const float* p, float (&v)[CV]) {
  if constexpr (CV == 4) {
    const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < CV; ++e) v[e] = __ldcg(p + e);
  }
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// A barrier of the block's first `threads` threads (whole warps) alone.
__device__ __forceinline__ void group_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

struct Args {
  const void* x;
  const void* g;
  const float* w;       // [D, K] f32 contiguous, 16-byte aligned; NULL: no dx
  const float* mask;
  void* dx;             // [B, T, D] contiguous, x's dtype; NULL: no dx
  float* partial;       // [stripes, B * frame blocks, K, channels]
  float* dw;            // [D, K]
  int* tickets;         // [stripes], zeroed by the launch
  int n_b, n_t, n_d;
  long long sxb, sxt, sgb, sgt;  // x's and g's strides in elements
  int k, pad_l;
  int vec, per_thread, channels, threads_t, k_const;   // the tile; per_thread is R
  cudaStream_t stream;
};

// Shared memory in f32: the xm tile [rows][channels] (rows = F + passes *
// KC - 1, zeros past F + K - 1), the gm tile [g_rows][channels], the thread
// rows' dw sums [threads_t][KC][channels]; with dx also the taps
// [channels][K] as they lie in w and the gm rows' masks.
size_t smem_bytes(int frames, int k, int kc, int channels, int threads_t, bool dx) {
  const size_t passes = (k + kc - 1) / kc;
  const size_t rows = frames + passes * kc - 1;
  const size_t g_rows = dx ? frames + k - 1 : frames;
  size_t n = (rows + g_rows) * channels + static_cast<size_t>(threads_t) * kc * channels;
  if (dx) n += static_cast<size_t>(channels) * k + (g_rows + 3) / 4 * 4;
  return n * sizeof(float);
}

// CV: channels per thread in the sums (4, or 1 on the scalar path); KF: K
// fixed at compile time (11), or 0 for any K; DX: dx is computed; R: frames
// per thread (unrolled, so the windows slide by renaming registers); EXIT:
// 0 runs it all; else where every block leaves, for the step breakdown of
// `chip_smoke.py --sweep` alone (fsmn_conv_bwd_steps_f32): 1 at the start,
// 2 after staging, 3 after the dw partials (no ticket taken), 4 after dx
// and the ticket (the last block of a stripe leaves before its sum).
template <typename T, int CV, int KF, bool DX, int R, int EXIT = 0>
__global__ void __launch_bounds__(MAX_THREADS)
    fsmn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ w, const float* __restrict__ mask,
                    T* __restrict__ dx, float* __restrict__ partial, float* __restrict__ dw,
                    int* __restrict__ tickets, int n_t, int n_d, long long sxb, long long sxt,
                    long long sgb, long long sgt, int k_arg, int pad_l) {
  constexpr int LV = CV == 1 ? 1 : 16 / sizeof(T);   // channels per load
  constexpr bool vector = CV > 1;
  constexpr int KC = KF > 0 ? KF : GENERIC_KC;        // taps per dw pass
  using Raw = std::conditional_t<vector, uint4, T>;
  const int k = KF > 0 ? KF : k_arg;
  const int pad_r = k - 1 - pad_l;
  const int n_x = blockDim.x;
  const int n_y = DX ? blockDim.y / 2 : blockDim.y;   // thread rows of each group
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * n_x + tx, n_threads = n_x * blockDim.y;
  const int width = n_x * CV;                   // channels of the block
  const int frames = n_y * R;                   // frames of the block
  const int passes = (k + KC - 1) / KC;
  const int rows = frames + passes * KC - 1;    // xm rows: frame t0 - pad_l + r
  const int x_used = frames + k - 1;            // xm rows that hold frames
  const int g_rows = DX ? frames + k - 1 : frames;
  const int g_off = DX ? pad_r : 0;             // gm row r: frame t0 - g_off + r
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * frames;
  const int c0 = blockIdx.x * width;
  const int n_blocks = gridDim.y * gridDim.z;   // blocks of the channel stripe
  const int blk = b * gridDim.y + blockIdx.y;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* gs = xs + static_cast<size_t>(rows) * width;
  float* red = gs + static_cast<size_t>(g_rows) * width;      // n_y x KC x width
  float* taps = red + static_cast<size_t>(n_y) * KC * width;  // width x k (dx)
  float* ms = taps + static_cast<size_t>(width) * k;          // g_rows (dx)
  __shared__ int last;
  if constexpr (EXIT == 1) return;

  // ---- one round trip: the taps by cp.async, then the two tiles
  if constexpr (DX) {
    const int n_w = min(width, n_d - c0) * k;
    const int n_w4 = n_w & ~3;
    const float* wb = w + static_cast<size_t>(c0) * k;
    for (int i = tid * 4; i < n_w4; i += n_threads * 4) cp_async16(taps + i, wb + i);
    for (int i = n_w4 + tid; i < n_w; i += n_threads) taps[i] = wb[i];
  }
  const int n_v = width / LV;                   // vectors per tile row
  const int sx = tid % n_v, sy = tid / n_v, row_step = n_threads / n_v;
  const int cs = c0 + sx * LV;                  // the first channel this thread stages
  const bool cs_in = cs < n_d;                  // LV divides D on the vector path
  const T* xb = x + b * sxb + cs;
  const T* gb = g + b * sgb + cs;
  const float* mb = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * n_t;
  const int total = rows + g_rows;
  for (int r0 = sy; r0 < total; r0 += BATCH * row_step) {
    Raw raw[BATCH];
    float m[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int r = r0 + i * row_step;
      const bool is_x = r < rows;
      const int rr = is_x ? r : r - rows;
      const int t = is_x ? t0 - pad_l + rr : t0 - g_off + rr;
      const bool ok = r < total && (!is_x || rr < x_used) && t >= 0 && t < n_t;
      m[i] = ok ? (mb != nullptr ? __ldg(mb + t) : 1.f) : 0.f;
      const T* src = is_x ? xb + t * sxt : gb + t * sgt;
      if constexpr (vector) {
        raw[i] = ok && cs_in ? __ldg(reinterpret_cast<const uint4*>(src)) : make_uint4(0, 0, 0, 0);
      } else {
        raw[i] = ok && cs_in ? src[0] : from_f32<T>(0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int r = r0 + i * row_step;
      if (r >= total) break;
      const bool is_x = r < rows;
      const int rr = is_x ? r : r - rows;
      float v[LV];
      if constexpr (vector)
        unpack<T>(raw[i], v);
      else
        v[0] = to_f32(raw[i]);
      if (mb != nullptr) {
#pragma unroll
        for (int e = 0; e < LV; ++e) v[e] = __fmul_rn(v[e], m[i]);
      }
      float* dst = (is_x ? xs : gs) + rr * width + sx * LV;
#pragma unroll
      for (int e = 0; e < LV; e += 4) {
        if constexpr (LV >= 4)
          *reinterpret_cast<float4*>(dst + e) = make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
        else
          dst[e] = v[e];
      }
      if constexpr (DX)
        if (!is_x && sx == 0) ms[rr] = m[i];
    }
  }
  if constexpr (DX) cp_async_wait_all();
  __syncthreads();
  if constexpr (EXIT == 2) return;

  // Two groups of n_y thread rows each (one with dw alone): the first
  // takes dw, the second dx, side by side over the same tiles.
  const bool dw_group = ty < n_y;
  const int row = dw_group ? ty : ty - n_y;     // the thread's row in its group
  const int c = c0 + tx * CV;                   // the thread's first channel
  const int o0 = row * R;                       // its first frame in the block
  const int n_f = max(0, min(R, n_t - t0 - o0));
  const float* xcol = xs + tx * CV;
  const float* gcol = gs + tx * CV;
  int ticket = 0;

  if (dw_group) {
    // ---- dw, KC taps a pass: frame t0 + o multiplies gm row o + g_off into
    // xm rows o + j (tap j); channels past D hold zeros and add nothing. The
    // rows' sums are then added in row order, RED_BATCH rows of shared
    // memory in flight, between barriers of this group alone.
    const int group = n_y * n_x;                // threads of the group
    float* pb = partial + (static_cast<size_t>(blockIdx.x) * n_blocks + blk) * k * width;
    for (int p = 0; p < passes; ++p) {
      const int j0 = p * KC;
      float acc[KC][CV];
#pragma unroll
      for (int j = 0; j < KC; ++j)
#pragma unroll
        for (int e = 0; e < CV; ++e) acc[j][e] = 0.f;
      {
        float win[KC][CV];
#pragma unroll
        for (int j = 0; j + 1 < KC; ++j) load_shared<CV>(xcol + (o0 + j0 + j) * width, win[j + 1]);
#pragma unroll
        for (int f = 0; f < R; ++f) {
#pragma unroll
          for (int j = 0; j + 1 < KC; ++j)
#pragma unroll
            for (int e = 0; e < CV; ++e) win[j][e] = win[j + 1][e];
          load_shared<CV>(xcol + (o0 + f + j0 + KC - 1) * width, win[KC - 1]);
          float gv[CV];
          load_shared<CV>(gcol + (o0 + f + g_off) * width, gv);
          if (f < n_f) {
#pragma unroll
            for (int j = 0; j < KC; ++j)
#pragma unroll
              for (int e = 0; e < CV; ++e) acc[j][e] = fmaf(gv[e], win[j][e], acc[j][e]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < KC; ++j)
        store_f32<CV>(red + (static_cast<size_t>(row) * KC + j) * width + tx * CV, acc[j]);
      group_sync(group);
      for (int i = tid; i < KC * n_x; i += group) {
        const int j = i / n_x, cx = i - j * n_x;
        if (j0 + j >= k) continue;
        const float* src = red + static_cast<size_t>(j) * width + cx * CV;
        const size_t step = static_cast<size_t>(KC) * width;
        float s[CV];
#pragma unroll
        for (int e = 0; e < CV; ++e) s[e] = 0.f;
        for (int y0 = 0; y0 < n_y; y0 += RED_BATCH, src += RED_BATCH * step) {
          float v[RED_BATCH][CV];
#pragma unroll
          for (int u = 0; u < RED_BATCH; ++u)
            if (y0 + u < n_y) load_shared<CV>(src + u * step, v[u]);
#pragma unroll
          for (int u = 0; u < RED_BATCH; ++u)
            if (y0 + u < n_y) {
#pragma unroll
              for (int e = 0; e < CV; ++e) s[e] += v[u][e];
            }
        }
        store_f32<CV>(pb + static_cast<size_t>(j0 + j) * width + cx * CV, s);
      }
      group_sync(group);
    }
    if constexpr (EXIT == 3) return;
    // ---- the block's ticket: the group's first thread publishes the
    // partial (the barrier above orders the group's stores before its
    // fence) while the other group works on dx
    if (tid == 0) {
      __threadfence();
      ticket = atomicAdd(tickets + blockIdx.x, 1);
    }
  } else if constexpr (DX) {
    // ---- dx: frame t0 + o reads gm rows o .. o + K - 1 (tap j at row o + j,
    // reversed tap K - 1 - j) and its residual at row o + pad_r
    if constexpr (EXIT == 3) return;
    if (c < n_d) {
      const float* my_taps = taps + static_cast<size_t>(tx) * CV * k;   // [CV][k]
      T* out = dx + (static_cast<size_t>(b) * n_t + t0 + o0) * n_d + c;
      if constexpr (KF > 0) {
        float wr[KF][CV];
        float win[KF][CV];
#pragma unroll
        for (int j = 0; j < KF; ++j)
#pragma unroll
          for (int e = 0; e < CV; ++e) wr[j][e] = round_as<T>(my_taps[e * KF + KF - 1 - j]);
#pragma unroll
        for (int j = 0; j + 1 < KF; ++j) load_shared<CV>(gcol + (o0 + j) * width, win[j + 1]);
#pragma unroll
        for (int f = 0; f < R; ++f) {
#pragma unroll
          for (int j = 0; j + 1 < KF; ++j)
#pragma unroll
            for (int e = 0; e < CV; ++e) win[j][e] = win[j + 1][e];
          load_shared<CV>(gcol + (o0 + f + KF - 1) * width, win[KF - 1]);
          float a[CV];
          load_shared<CV>(gcol + (o0 + f + pad_r) * width, a);
#pragma unroll
          for (int j = 0; j < KF; ++j)
#pragma unroll
            for (int e = 0; e < CV; ++e) a[e] = __fadd_rn(a[e], __fmul_rn(win[j][e], wr[j][e]));
          if (mb != nullptr) {
            const float mo = ms[o0 + f + pad_r];
#pragma unroll
            for (int e = 0; e < CV; ++e) a[e] = __fmul_rn(a[e], mo);
          }
          if (f < n_f) store_vec<T, CV>(out + static_cast<size_t>(f) * n_d, a);
        }
      } else {
        for (int f = 0; f < n_f; ++f) {
          float a[CV];
          load_shared<CV>(gcol + (o0 + f + pad_r) * width, a);
          for (int j = 0; j < k; ++j) {
            float gv[CV];
            load_shared<CV>(gcol + (o0 + f + j) * width, gv);
#pragma unroll
            for (int e = 0; e < CV; ++e)
              a[e] = __fadd_rn(a[e], __fmul_rn(gv[e], round_as<T>(my_taps[e * k + k - 1 - j])));
          }
          if (mb != nullptr) {
            const float mo = ms[o0 + f + pad_r];
#pragma unroll
            for (int e = 0; e < CV; ++e) a[e] = __fmul_rn(a[e], mo);
          }
          store_vec<T, CV>(out + static_cast<size_t>(f) * n_d, a);
        }
      }
    }
  }

  // ---- the block that drew the stripe's last ticket adds the stripe's
  // partials in block order, RED_BATCH loads in flight, and writes dw
  if (tid == 0) last = ticket == n_blocks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if constexpr (EXIT == 4) return;
  const size_t step = static_cast<size_t>(k) * width;
  for (int i = tid; i < k * n_x; i += n_threads) {
    const int j = i / n_x, cx = i - j * n_x;
    const float* src = partial + static_cast<size_t>(blockIdx.x) * n_blocks * step +
                       static_cast<size_t>(j) * width + cx * CV;
    float s[CV];
#pragma unroll
    for (int e = 0; e < CV; ++e) s[e] = 0.f;
    for (int q0 = 0; q0 < n_blocks; q0 += RED_BATCH, src += RED_BATCH * step) {
      float v[RED_BATCH][CV];
#pragma unroll
      for (int u = 0; u < RED_BATCH; ++u)
        if (q0 + u < n_blocks) load_cg<CV>(src + u * step, v[u]);
#pragma unroll
      for (int u = 0; u < RED_BATCH; ++u)
        if (q0 + u < n_blocks) {
#pragma unroll
          for (int e = 0; e < CV; ++e) s[e] += v[u][e];
        }
    }
    float* out = dw + static_cast<size_t>(c0 + cx * CV) * k + j;
#pragma unroll
    for (int e = 0; e < CV; ++e)
      if (c0 + cx * CV + e < n_d) out[e * k] = s[e];
  }
}

template <typename T, int CV, int KF, bool DX, int R, int EXIT = 0>
int launch(const Args& a) {
  constexpr int KC = KF > 0 ? KF : GENERIC_KC;
  const int n_x = a.channels / CV;
  const dim3 block(n_x, (DX ? 2 : 1) * a.threads_t);
  const int frames = a.threads_t * R;
  const dim3 grid((a.n_d + a.channels - 1) / a.channels, (a.n_t + frames - 1) / frames, a.n_b);
  const size_t smem = smem_bytes(frames, a.k, KC, a.channels, a.threads_t, DX);
  auto kernel = fsmn_bwd_kernel<T, CV, KF, DX, R, EXIT>;
  if (smem > SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaError_t err = cudaMemsetAsync(a.tickets, 0, grid.x * sizeof(int), a.stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, block, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.w, a.mask, static_cast<T*>(a.dx),
      a.partial, a.dw, a.tickets, a.n_t, a.n_d, a.sxb, a.sxt, a.sgb, a.sgt, a.k, a.pad_l);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CV, int KF, int R>
int by_dx(const Args& a) {
  return a.dx != nullptr ? launch<T, CV, KF, true, R>(a) : launch<T, CV, KF, false, R>(a);
}

template <typename T, int CV, int KF>
int by_frames(const Args& a) {
  switch (a.per_thread) {
    case 2: return by_dx<T, CV, KF, 2>(a);
    case 4: return by_dx<T, CV, KF, 4>(a);
    case 8: return by_dx<T, CV, KF, 8>(a);
    case 16: return by_dx<T, CV, KF, 16>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool valid(const Args& a) {
  const int cv = a.vec == 1 ? 1 : 4;
  return a.n_b >= 1 && a.n_t >= 1 && a.n_d >= 1 && a.k >= 1 && a.k <= 128 && a.pad_l >= 0 &&
         a.pad_l <= a.k - 1 && a.threads_t >= 1 && a.channels % 8 == 0 &&
         (a.channels / cv) * a.threads_t % 32 == 0 &&
         (a.dx != nullptr ? 2 : 1) * (a.channels / cv) * a.threads_t <= MAX_THREADS &&
         (a.dx != nullptr) == (a.w != nullptr);
}

template <typename T>
int dispatch(const Args& a) {
  if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (a.vec == static_cast<int>(16 / sizeof(T))) {
    if (a.k_const == 11 && a.k == 11) return by_frames<T, 4, 11>(a);
    if (a.k_const == 0) return by_frames<T, 4, 0>(a);
  } else if (a.vec == 1 && a.k_const == 0 && a.per_thread == 4) {
    return by_dx<T, 1, 0, 4>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

Args pack(const void* x, const void* g, const void* w, const void* mask, void* dx,
          void* partial, void* dw, void* tickets, int n_b, int n_t, int n_d, long long sxb,
          long long sxt, long long sgb, long long sgt, int k, int pad_l, int vec,
          int per_thread, int channels, int threads_t, int k_const, void* stream) {
  return Args{x,     g,     static_cast<const float*>(w), static_cast<const float*>(mask),
              dx,    static_cast<float*>(partial), static_cast<float*>(dw),
              static_cast<int*>(tickets), n_b, n_t, n_d, sxb, sxt, sgb, sgt, k, pad_l, vec,
              per_thread, channels, threads_t, k_const, static_cast<cudaStream_t>(stream)};
}

template <int R>
int by_exit(const Args& a, int exit_after) {
  switch (exit_after) {
    case 1: return launch<float, 4, 11, true, R, 1>(a);
    case 2: return launch<float, 4, 11, true, R, 2>(a);
    case 3: return launch<float, 4, 11, true, R, 3>(a);
    case 4: return launch<float, 4, 11, true, R, 4>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, g: [B, T, D] at their own (batch, frame) strides in elements, unit
// channel stride, the same dtype; w: [D, K] f32 contiguous, 16-byte aligned,
// and dx: [B, T, D] contiguous in x's dtype, both NULL when dx is not wanted;
// mask: [B, T] float32 contiguous or NULL; partial: f32 scratch of
// stripes * B * ceil(T / frames) * K * channels; dw: [D, K] f32 contiguous;
// tickets: `stripes` ints, the call's own (zeroed on the stream before the
// kernel). The tile: vec (16 / sizeof(T): the vector path; 1: the scalar
// path), per_thread (frames per thread: 2, 4, 8 or 16
// on the vector path, 4 on the scalar one), channels per block (a multiple
// of 8), threads_t (thread rows of each group: whole warps, and at most 384
// threads per block with both groups), k_const (0, or 11 for the K = 11
// instantiation, vector path only). Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int fsmn_conv_bwd_f32(const void* x, const void* g, const void* w, const void* mask,
                                 void* dx, void* partial, void* dw, void* tickets, int n_b,
                                 int n_t, int n_d, long long sxb, long long sxt, long long sgb,
                                 long long sgt, int k, int pad_l, int vec, int per_thread,
                                 int channels, int threads_t, int k_const, void* stream) {
  return dispatch<float>(pack(x, g, w, mask, dx, partial, dw, tickets, n_b, n_t, n_d, sxb, sxt,
                              sgb, sgt, k, pad_l, vec, per_thread, channels, threads_t, k_const,
                              stream));
}

extern "C" int fsmn_conv_bwd_bf16(const void* x, const void* g, const void* w, const void* mask,
                                  void* dx, void* partial, void* dw, void* tickets, int n_b,
                                  int n_t, int n_d, long long sxb, long long sxt, long long sgb,
                                  long long sgt, int k, int pad_l, int vec, int per_thread,
                                  int channels, int threads_t, int k_const, void* stream) {
  return dispatch<__nv_bfloat16>(pack(x, g, w, mask, dx, partial, dw, tickets, n_b, n_t, n_d,
                                      sxb, sxt, sgb, sgt, k, pad_l, vec, per_thread, channels,
                                      threads_t, k_const, stream));
}

// The step breakdown of `chip_smoke.py --sweep`: fsmn_conv_bwd_f32's launch
// with dx and dw at K = 11 on the vector path (k_const 11, per_thread 4, 8
// or 16), every block leaving at step `exit_after` (1-4, EXIT above). Its
// results are incomplete; nothing but the sweep calls it.
extern "C" int fsmn_conv_bwd_steps_f32(const void* x, const void* g, const void* w,
                                       const void* mask, void* dx, void* partial, void* dw,
                                       void* tickets, int n_b, int n_t, int n_d, long long sxb,
                                       long long sxt, long long sgb, long long sgt, int k,
                                       int pad_l, int vec, int per_thread, int channels,
                                       int threads_t, int k_const, void* stream,
                                       int exit_after) {
  const Args a = pack(x, g, w, mask, dx, partial, dw, tickets, n_b, n_t, n_d, sxb, sxt, sgb, sgt,
                      k, pad_l, vec, per_thread, channels, threads_t, k_const, stream);
  if (!valid(a) || a.dx == nullptr || a.vec != 4 || a.k != 11 || a.k_const != 11)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (a.per_thread) {
    case 4: return by_exit<4>(a, exit_after);
    case 8: return by_exit<8>(a, exit_after);
    case 16: return by_exit<16>(a, exit_after);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
