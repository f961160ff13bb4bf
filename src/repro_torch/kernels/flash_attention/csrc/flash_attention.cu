// Flash-attention forward for Hopper (sm_90a) on the tensor cores, 3xTF32.
//
// Replaces src/repro/kernels/flash_attention/kernel.py: flash_attention_kernel
// (the Pallas TPU kernel, body _flash_kernel).  Same function: causal and/or
// sliding-window softmax attention over q (B, Sq, H, hd) and unexpanded k/v
// (B, Sk, Hkv, hd), q head h reading kv head h / (H / Hkv), an online softmax
// with f32 m, l and acc, the output acc / max(l, 1e-30) in q's dtype.  A row
// that no key is live for gets the uniform average of all Sk values, as the
// full softmax of the plain version (ref.py) gives it.
//
// What bounds it on an H100: operations.  Every live (q, k) pair costs 4 * hd
// flops (the q.k dot and the p * v update) against 16 * hd bytes of q, k, v
// and o per *row* of q; at the serving shapes (Sk in the thousands) that is
// hundreds of flops per byte.  Both products run on the tensor cores in
// 3xTF32 (../../csrc/mma_tf32x3.cuh): each f32 operand split into two TF32
// parts and three TF32 products summed in f32, which holds the f32
// reference's 2e-5 where one TF32 product would not.  So the bound is
// 3 * live pairs * 4 * hd / 494.7 TFLOP/s (dense TF32), 2.5x tighter than
// the 67 TFLOP/s of f32 FFMA.
// What the design does about it (FlashAttention-2 shaped, mma.sync):
//
// * the route is mma.sync.m16n8k8 (TF32), not wgmma: the f32 -> (big, small)
//   split lives in registers between a fragment load and its mma, and the
//   fragment loads read any shared-memory layout (V in P.V is k-major, which
//   wgmma's TF32 form does not take);
// * a block of 4 warps owns 64 query rows of one q head, each warp 16 rows.
//   The block's q sits in shared memory (split at each fragment load); a
//   warp keeps its output accumulator (hd / 2 floats per thread) and the
//   16 x 32 score tile in registers for the whole key loop.  Few registers
//   and 32-key tiles let 4 blocks (16 warps) share an SM at hd 32 and 64, 3
//   at hd 80 and 2 at hd 128, which hides the mma and shared-memory
//   latencies;
// * k and v stream in 32-key tiles through a two-stage cp.async ring in
//   shared memory, in the inputs' own type (bf16 is converted at the
//   fragment load; bf16 operands are exact in TF32, so their cross products
//   are skipped: q.k is one mma, p.v two);
// * the tensor cores' f32 accumulation does not round to nearest, and acc
//   sums over thousands of keys: so each tile's P.V is taken from zero in
//   mma accumulators (12 products at most per element) and added to acc in
//   f32, which keeps the 2e-5 at Sk 2048 and beyond;
// * S = q.k^T on mma, then the online softmax on the accumulator in place:
//   the scale, the mask (masked p = 0 explicitly: a row's first live tile
//   may begin with masked keys, which never reach l or acc; the TPU kernel
//   relies on exp(-1e30 - m) underflowing instead; a tile live for all the
//   warp's rows skips the mask), one running max per row
//   shared by the row's quad of threads, exp2f on scores scaled by
//   scale * log2(e) (the same softmax, in base 2), and P stays in registers:
//   the m16n8 accumulator holds columns (2t, 2t + 1), and the shared loaders
//   relabel the keys of each 8-key step so that it is the A fragment of P.V
//   as it stands (V's rows 2t and 2t + 1 feed k-slots t and t + 4);
// * fully masked work is skipped by loop bounds, not by masks: a block's
//   tiles run from its first row's window edge to its last row (causal),
//   each warp skips the 8-key groups outside its own rows' range, and the
//   causal blocks with the most work are launched first;
// * shared memory, 64 q rows x (hd + 8) + 2 stages x 32 keys x (hd + 8 +
//   hd + 4) elements: 54 KB in f32 at hd 64, 67 KB at hd 80, 103 KB at hd
//   128.  The leading dimensions keep the fragment loads free of bank
//   conflicts;
// * q, k, v and o are read and written by strides in the (B, S, H, hd)
//   layout the projections produce (no transposes), with 64-bit offsets.
//
// The kernel allocates nothing.  The host function launches on the stream it
// is given and returns cudaGetLastError(); the Python wrapper raises on a
// nonzero return.  Built by nvcc into a shared library with this plain C
// interface (see kernel.py); no PyTorch headers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int THREADS = 128;  // 4 warps
constexpr int BQ = 64;        // query rows per block, 16 per warp
constexpr int BK = 32;        // keys per shared-memory tile
constexpr int NG = BK / 8;    // 8-key groups of a tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, Hkv, Sq, Sk;
  long long q_sb, q_ss, q_sh;  // element strides of (B, S, H); hd is contiguous
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal;
  int window;  // 0 = no window
  float scale;
};

template <int HD>
struct Tile {
  static constexpr int KLD = HD + 8;  // q and k rows: 8-byte loads along hd
  static constexpr int VLD = HD + 4;  // v rows: k-major loads
  static constexpr int STAGE = BK * (KLD + VLD);  // elements per ring stage
  static constexpr int Q = BQ * KLD;  // the block's q rows, before the ring
};

template <typename T>
size_t smem_bytes(int hd) {
  return (size_t)(BQ * (hd + 8) + 2 * BK * (2 * hd + 12)) * sizeof(T);
}

__device__ __forceinline__ void stg2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void stg2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Issue the copies of keys [t0, t0 + BK) of one (b, kv head) into a ring
// stage; keys at or past Sk are zero-filled, so a masked key's p = 0 never
// meets a NaN.
template <typename T, int HD>
__device__ __forceinline__ void load_kv(T* stage, const T* kb, const T* vb, long long k_ss,
                                        long long v_ss, int t0, int Sk) {
  using TL = Tile<HD>;
  constexpr int C4 = HD / 4;
  T* Ks = stage;
  T* Vs = stage + BK * TL::KLD;
  for (int idx = threadIdx.x; idx < BK * C4; idx += THREADS) {
    const int r = idx / C4;
    const int c = (idx - r * C4) * 4;
    const int j = t0 + r;
    const bool ok = j < Sk;
    const long long jj = ok ? j : 0;
    cp_async4(Ks + r * TL::KLD + c, kb + jj * k_ss + c, ok);
    cp_async4(Vs + r * TL::VLD + c, vb + jj * v_ss + c, ok);
  }
}

// blocks per SM that the registers (and the shared memory, in f32) allow
template <int HD>
constexpr int min_blocks() {
  return HD <= 64 ? 4 : (HD <= 80 ? 3 : 2);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, min_blocks<HD>()) flash_fwd_kernel(const Params p) {
  using TL = Tile<HD>;
  constexpr int KS = HD / 8;  // k steps of q.k^T, and n tiles of o
  constexpr bool EX = std::is_same<T, __nv_bfloat16>::value;  // inputs exact in TF32

  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);
  T* ring = Qs + TL::Q;

  const int iq = gridDim.x - 1 - blockIdx.x;  // heaviest causal blocks first
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y - b * p.H;
  const int hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = iq * BQ;
  const int w0 = q0 + warp * 16;
  const int rows[2] = {w0 + g, w0 + g + 8};  // this thread's two query rows

  const T* qb = static_cast<const T*>(p.q) + (long long)b * p.q_sb + (long long)h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + (long long)b * p.k_sb + (long long)hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + (long long)b * p.v_sb + (long long)hk * p.v_sh;

  // the block's q rows (zero past Sq), in the first copy group
  for (int idx = threadIdx.x; idx < BQ * (HD / 4); idx += THREADS) {
    const int r = idx / (HD / 4), c = (idx - r * (HD / 4)) * 4;
    const bool ok = q0 + r < p.Sq;
    cp_async4(Qs + r * TL::KLD + c, ok ? qb + (long long)(q0 + r) * p.q_ss + c : qb, ok);
  }
  const T* Qw = Qs + warp * 16 * TL::KLD;  // this warp's rows
  float acc[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
  // scores in base 2: exp(x * scale) = exp2(x * scale * log2(e)), one MUFU op
  const float scale2 = p.scale * 1.4426950408889634f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  // the block's key range: live keys of its rows lie in [lo, hi)
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  const int hi = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  const int lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  // this warp's key range (warp-uniform)
  const int w_last = min(w0 + 15, p.Sq - 1);
  const int whi = w0 >= p.Sq ? 0 : (p.causal ? min(p.Sk, w_last + 1) : p.Sk);
  const int wlo = p.window > 0 ? max(0, w0 - p.window + 1) : 0;

  const int t_begin = (lo / BK) * BK;
  if (t_begin < hi) load_kv<T, HD>(ring, kb, vb, p.k_ss, p.v_ss, t_begin, p.Sk);
  cp_async_commit();
  int stage = 0;
  for (int t0 = t_begin; t0 < hi; t0 += BK) {
    if (t0 + BK < hi)
      load_kv<T, HD>(ring + (stage ^ 1) * TL::STAGE, kb, vb, p.k_ss, p.v_ss, t0 + BK, p.Sk);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* Ks = ring + stage * TL::STAGE;
    const T* Vs = Ks + BK * TL::KLD;

    if (t0 < whi && t0 + BK > wlo) {
      // the 8-key groups that hold a live key for some row of this warp
      const int g0 = max(0, (wlo - t0) / 8);
      const int g1 = min(NG, (whi - t0 + 7) / 8);
      float s[NG][4];
#pragma unroll
      for (int j = 0; j < NG; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        float x[4];
        load_a_rows(x, Qw + kk * 8, TL::KLD);
        FragA a;
        split_a<EX>(a, x);
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          float y[2];
          load_b_rows(y, Ks + j * 8 * TL::KLD + kk * 8, TL::KLD);
          FragB fb;
          split_b<EX>(fb, y);
          mma3<EX, EX>(s[j], a, fb);
        }
      }
      // scale and mask; the row max over this tile, shared by the row's quad.
      // A tile live for every row of the warp (most of them) skips the mask.
      const bool full = w0 + 15 < p.Sq && t0 + BK <= p.Sk && (!p.causal || t0 + BK - 1 <= w0) &&
                        (p.window <= 0 || w0 + 15 - t0 < p.window);
      float mc[2] = {-INFINITY, -INFINITY};
      if (full) {
#pragma unroll
        for (int j = 0; j < NG; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] *= scale2;
            mc[e / 2] = fmaxf(mc[e / 2], s[j][e]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < NG; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = rows[e / 2];
            const int kj = t0 + 8 * j + 2 * t + (e & 1);
            const bool live = j >= g0 && j < g1 && i < p.Sq && kj < p.Sk &&
                              (!p.causal || kj <= i) && (p.window <= 0 || i - kj < p.window);
            s[j][e] = live ? s[j][e] * scale2 : -INFINITY;
            mc[e / 2] = fmaxf(mc[e / 2], s[j][e]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 1));
        mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 2));
        if (mc[i] > m[i]) {  // a live key raised the running max: rescale once
          const float alpha = exp2f(m[i] - mc[i]);  // m = -inf gives 0
          l[i] *= alpha;
#pragma unroll
          for (int n = 0; n < KS; ++n) {
            acc[n][2 * i] *= alpha;
            acc[n][2 * i + 1] *= alpha;
          }
          m[i] = mc[i];
        }
      }
#pragma unroll
      for (int j = 0; j < NG; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = s[j][e] == -INFINITY ? 0.f : exp2f(s[j][e] - m[e / 2]);
          l[e / 2] += s[j][e];
        }
      }
      // acc += P.V over the live key groups, 64 columns of hd at a time: the
      // tile's product from zero in the mma accumulators, then added to acc
      // in f32 (so that acc's sum over the keys rounds to nearest, as FFMA
      // does, and not as the tensor cores' accumulation does)
#pragma unroll
      for (int n0 = 0; n0 < KS; n0 += 8) {
        constexpr int NW = KS < 8 ? KS : 8;
        float o[NW][4];
#pragma unroll
        for (int n = 0; n < NW; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          if (j >= g0 && j < g1) {
            const float x[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
            FragA a;
            split_a<false>(a, x);
#pragma unroll
            for (int n = 0; n < NW; ++n) {
              if (n0 + n < KS) {
                float y[2];
                load_b_cols(y, Vs + j * 8 * TL::VLD + (n0 + n) * 8, TL::VLD);
                FragB fb;
                split_b<EX>(fb, y);
                mma3<false, EX>(o[n], a, fb);
              }
            }
          }
        }
#pragma unroll
        for (int n = 0; n < NW; ++n) {
          if (n0 + n < KS) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n0 + n][e] += o[n][e];
          }
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
    stage ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  // Rows with no live key: the plain version's softmax over all-masked
  // scores is uniform, so the output is the mean of the Sk values.
  const bool dead[2] = {rows[0] < p.Sq && l[0] == 0.f, rows[1] < p.Sq && l[1] == 0.f};
  if (__syncthreads_or(dead[0] || dead[1])) {
    const T* Vs = ring + BK * TL::KLD;
    for (int t0 = 0; t0 < p.Sk; t0 += BK) {
      __syncthreads();
      load_kv<T, HD>(ring, kb, vb, p.k_ss, p.v_ss, t0, p.Sk);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      const int nk = min(BK, p.Sk - t0);
      for (int j = 0; j < nk; ++j) {
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          const float2 vv = ld2(Vs + j * TL::VLD + n * 8 + 2 * t);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (dead[i]) {
              acc[n][2 * i] += vv.x;
              acc[n][2 * i + 1] += vv.y;
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (dead[i]) l[i] = (float)p.Sk;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= p.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* op = static_cast<T*>(p.o) + (long long)b * p.o_sb + (long long)rows[i] * p.o_ss +
            (long long)h * p.o_sh + 2 * t;
#pragma unroll
    for (int n = 0; n < KS; ++n) stg2(op + n * 8, acc[n][2 * i] / denom, acc[n][2 * i + 1] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(HD);
  auto kernel = flash_fwd_kernel<T, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Params& p, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(p, stream);
    case 64:
      return launch<T, 64>(p, stream);
    case 80:
      return launch<T, 80>(p, stream);
    case 128:
      return launch<T, 128>(p, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  Returns the
// cudaError_t of the launch (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype, int hd,
                        int B, int H, int Hkv, int Sq, int Sk, long long q_sb, long long q_ss,
                        long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh, long long o_sb,
                        long long o_ss, long long o_sh, int causal, int window, float scale,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Params p{q,    k,    v,    o,    B,    H,    Hkv,    Sq,     Sk,    q_sb,
                 q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,   v_sh,   o_sb,  o_ss,
                 o_sh, causal, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_hd<float>(hd, p, s);
  if (dtype == 1) return (int)dispatch_hd<__nv_bfloat16>(hd, p, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
