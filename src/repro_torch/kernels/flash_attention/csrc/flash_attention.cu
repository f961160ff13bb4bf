// Flash-attention forward for Hopper (sm_90a), f32 SIMT.
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
// flops (the q.k dot and the p * v update) against 16 * hd bytes of q, k, v and
// o per *row* of q; at the serving shapes (Sk in the thousands) that is
// hundreds of flops per byte, far above the card's f32 balance point, so the
// bound is live pairs * 4 * hd / 67 TFLOP/s (no tensor cores: this kernel is
// FFMA in f32, which keeps the f32 result within the reference's 2e-5).
// What the design does about it:
//
// * one thread (hd 64) or an interleaved pair of threads (hd 80, 128) owns one
//   query row: the row's q and its acc stay in registers for the whole k loop,
//   so the inner loop is FFMAs fed by one broadcast shared-memory load per four
//   FFMAs;
// * a block of 128 threads (128 rows at hd 64, 64 rows at hd 80 and 128)
//   streams 64-key tiles of k and v through shared memory (f32, converted
//   from bf16 on the way in), shared by all its rows; a row's registers
//   (q, acc: up to 2 * hd / TPR floats) leave room for one or two blocks per
//   SM, and those blocks hide each other's tile loads;
// * the online softmax runs per chunk of 8 keys: one max, one rescale of acc
//   and 8 expf per chunk, so the rescale costs hd / 8 multiplies per key;
// * fully masked work is skipped by loop bounds, not by masks: a block's k
//   tiles stop at its last row (causal) and start at its first row's window
//   edge; inside a tile each warp skips chunks outside its own rows' range;
//   the causal blocks with the most work are launched first;
// * masked keys get p = 0 explicitly, so a row whose first live chunk begins
//   with masked keys never adds them to l or acc (the TPU kernel relies on
//   exp(-1e30 - m) underflowing to 0 instead);
// * q, k, v and o are read and written by strides in the (B, S, H, hd) layout
//   the projections produce (no transposes), with 64-bit base offsets.
//
// The kernel allocates nothing.  The host function launches on the stream it
// is given and returns cudaGetLastError(); the Python wrapper raises on a
// nonzero return.  Built by nvcc into a shared library with this plain C
// interface (see kernel.py); no PyTorch headers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // per block: 128 rows at hd 64, 64 rows at hd 80 and 128
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int NC = 8;         // keys per online-softmax chunk
constexpr unsigned FULL = 0xffffffffu;

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

template <typename T>
struct IO;

template <>
struct IO<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <>
struct IO<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    return make_float4(__bfloat162float(lo.x), __bfloat162float(lo.y),
                       __bfloat162float(hi.x), __bfloat162float(hi.y));
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
    __nv_bfloat162 lo, hi;
    lo.x = __float2bfloat16(v.x);
    lo.y = __float2bfloat16(v.y);
    hi.x = __float2bfloat16(v.z);
    hi.y = __float2bfloat16(v.w);
    uint2 raw;
    raw.x = *reinterpret_cast<const unsigned*>(&lo);
    raw.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

// Copy keys [t0, t0 + BK) of one (b, kv head) into a (BK, hd) f32 tile; keys
// at or past Sk are zero, so a masked key's p = 0 never meets a NaN.
template <typename T, int C4>
__device__ __forceinline__ void load_tile(float4* tile, const T* base, long long ss,
                                          int t0, int Sk) {
  for (int idx = threadIdx.x; idx < BK * C4; idx += THREADS) {
    const int row = idx / C4;
    const int c = idx - row * C4;
    const int j = t0 + row;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < Sk) val = IO<T>::load4(base + (long long)j * ss + 4 * c);
    tile[idx] = val;
  }
}

template <typename T, int HD, int TPR>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const Params p) {
  constexpr int C4 = HD / 4;     // float4 chunks of a row
  constexpr int MY4 = C4 / TPR;  // chunks this thread owns: c * TPR + part
  constexpr int BQ = THREADS / TPR;  // query rows per block
  constexpr int ROWS_PER_WARP = 32 / TPR;
  static_assert(HD % 4 == 0 && C4 % TPR == 0, "hd must split into float4 chunks");

  extern __shared__ float4 smem[];
  float4* Ks = smem;            // (BK, C4)
  float4* Vs = smem + BK * C4;  // (BK, C4)

  const int iq = gridDim.x - 1 - blockIdx.x;  // heaviest causal blocks first
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y - b * p.H;
  const int hk = h / (p.H / p.Hkv);
  const int tid = threadIdx.x;
  const int part = tid % TPR;
  const int q0 = iq * BQ;
  const int i = q0 + tid / TPR;  // this thread's query row
  const bool row_ok = i < p.Sq;

  const T* qp = static_cast<const T*>(p.q) + (long long)b * p.q_sb + (long long)i * p.q_ss +
                (long long)h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + (long long)b * p.k_sb + (long long)hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + (long long)b * p.v_sb + (long long)hk * p.v_sh;

  float4 qr[MY4];
  float4 acc[MY4];
#pragma unroll
  for (int c = 0; c < MY4; ++c) {
    qr[c] = row_ok ? IO<T>::load4(qp + 4 * (c * TPR + part)) : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY;
  float l = 0.f;

  // the block's key range: live keys of its rows lie in [lo, hi)
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  const int hi = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  const int lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  // this warp's key range (warp-uniform, so the pair shuffle stays converged)
  const int w0 = q0 + (tid / 32) * ROWS_PER_WARP;
  const int w1 = min(w0 + ROWS_PER_WARP, p.Sq) - 1;
  const int whi = w0 >= p.Sq ? 0 : (p.causal ? min(p.Sk, w1 + 1) : p.Sk);
  const int wlo = p.window > 0 ? max(0, w0 - p.window + 1) : 0;

  for (int t0 = (lo / BK) * BK; t0 < hi; t0 += BK) {
    __syncthreads();  // the previous tile is consumed
    load_tile<T, C4>(Ks, kb, p.k_ss, t0, p.Sk);
    load_tile<T, C4>(Vs, vb, p.v_ss, t0, p.Sk);
    __syncthreads();

    for (int c0 = 0; c0 < BK; c0 += NC) {
      const int j0 = t0 + c0;
      if (j0 >= whi || j0 + NC <= wlo) continue;  // no live key for this warp

      float s[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) s[j] = 0.f;
#pragma unroll
      for (int c = 0; c < MY4; ++c) {
        const float4 qv = qr[c];
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const float4 kv = Ks[(c0 + j) * C4 + c * TPR + part];
          s[j] = fmaf(qv.x, kv.x, s[j]);
          s[j] = fmaf(qv.y, kv.y, s[j]);
          s[j] = fmaf(qv.z, kv.z, s[j]);
          s[j] = fmaf(qv.w, kv.w, s[j]);
        }
      }
      if (TPR == 2) {
#pragma unroll
        for (int j = 0; j < NC; ++j) s[j] += __shfl_xor_sync(FULL, s[j], 1);
      }

      float mc = -INFINITY;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int kj = j0 + j;
        const bool live = row_ok && kj < p.Sk && (!p.causal || kj <= i) &&
                          (p.window <= 0 || i - kj < p.window);
        s[j] = live ? s[j] * p.scale : -INFINITY;
        mc = fmaxf(mc, s[j]);
      }
      if (mc > m) {  // a live key raised the running max: rescale once
        const float alpha = expf(m - mc);  // m = -inf gives 0
        l *= alpha;
#pragma unroll
        for (int c = 0; c < MY4; ++c) {
          acc[c].x *= alpha;
          acc[c].y *= alpha;
          acc[c].z *= alpha;
          acc[c].w *= alpha;
        }
        m = mc;
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        s[j] = s[j] == -INFINITY ? 0.f : expf(s[j] - m);
        l += s[j];
      }
#pragma unroll
      for (int c = 0; c < MY4; ++c) {
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const float4 vv = Vs[(c0 + j) * C4 + c * TPR + part];
          acc[c].x = fmaf(s[j], vv.x, acc[c].x);
          acc[c].y = fmaf(s[j], vv.y, acc[c].y);
          acc[c].z = fmaf(s[j], vv.z, acc[c].z);
          acc[c].w = fmaf(s[j], vv.w, acc[c].w);
        }
      }
    }
  }

  // Rows with no live key: the plain version's softmax over all-masked
  // scores is uniform, so the output is the mean of the Sk values.
  const bool dead = row_ok && l == 0.f;
  if (__syncthreads_or(dead)) {
    for (int t0 = 0; t0 < p.Sk; t0 += BK) {
      __syncthreads();
      load_tile<T, C4>(Vs, vb, p.v_ss, t0, p.Sk);
      __syncthreads();
      if (dead) {
        const int n = min(BK, p.Sk - t0);
        for (int j = 0; j < n; ++j) {
#pragma unroll
          for (int c = 0; c < MY4; ++c) {
            const float4 vv = Vs[j * C4 + c * TPR + part];
            acc[c].x += vv.x;
            acc[c].y += vv.y;
            acc[c].z += vv.z;
            acc[c].w += vv.w;
          }
        }
      }
    }
    if (dead) l = (float)p.Sk;
  }

  if (!row_ok) return;
  const float denom = fmaxf(l, 1e-30f);
  T* op = static_cast<T*>(p.o) + (long long)b * p.o_sb + (long long)i * p.o_ss +
          (long long)h * p.o_sh;
#pragma unroll
  for (int c = 0; c < MY4; ++c) {
    const float4 a = acc[c];
    IO<T>::store4(op + 4 * (c * TPR + part),
                  make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom));
  }
}

template <typename T, int HD, int TPR>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int BQ = THREADS / TPR;
  const size_t smem = 2ull * BK * HD * sizeof(float);
  auto kernel = flash_fwd_kernel<T, HD, TPR>;
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
    case 64:
      return launch<T, 64, 1>(p, stream);
    case 80:
      return launch<T, 80, 2>(p, stream);
    case 128:
      return launch<T, 128, 2>(p, stream);
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
