// Chunkwise-parallel mLSTM forward for Hopper (sm_90a), f32 SIMT.
//
// Replaces src/repro/kernels/mlstm_chunk/kernel.py: mlstm_chunk_kernel (the
// Pallas TPU kernel, body _mlstm_kernel).  Same function: the xLSTM matrix
// memory cell over q, k (B, H, S, dk), v (B, H, S, dv) and f32 gates
// (B, H, S), with an exponential input gate, a log-sigmoid forget gate and
// the max-stabilizer m, computed chunk by chunk: within a chunk of L rows a
// decay-masked (L x L) attention, across chunks the carried matrix memory
// C (dk x dv), normalizer n (dk) and stabilizer m, starting from zero.  It
// writes h (B, H, S, dv) in v's dtype and the final C, n, m in f32.  The
// stabilizer algebra is the reference's, term for term: log-sigmoid as
// min(f, 0) - log1p(exp(-|f|)), the row max of the masked decay
// (b_t - b_s) + i_s, the carry's M, expf (not __expf), IEEE division in
// h = num / max(|den|, exp(-m_t)).  Built without --use_fast_math.
//
// What bounds it on an H100: operations.  Per chunk and (batch, head) it does
// L*L*dk (scores) + L*L*dv (w.v) + 2*L*dk*dv (q.C and the C update) multiply-
// adds against (2*dk + 2*dv) * L * 4 bytes of q, k, v, h; at the serving shape
// (L = 128, dk = dv = 512) that is ~150 flops per byte, far above the card's
// f32 balance point (20), so the bound is the flops over 67 TFLOP/s (f32
// FFMA, no tensor cores: TF32 would not hold the reference's 2e-4).
// What the design does about it:
//
// * the state does not fit one SM: C at dk = dv = 512 in f32 is 1 MiB, a
//   block has at most 227 KB of shared memory.  So dv is split over blocks:
//   the grid is (B*H, dv / 64), and each block keeps its (dk, 64) slice of C
//   (128 KB at dk 512) and the whole n (2 KB) in shared memory for the whole
//   sequence.  Nothing carries between blocks: a block recomputes its chunk's
//   gates, decay matrix and (L x L) scores q.k^T, which every column slice
//   needs.  At the serving shape that recompute is 8.4 of the block's 17.1
//   million multiply-adds per chunk (accepted for now; 256 blocks fill the
//   132 SMs twice);
// * the chunks run in order inside the block (the state carries from one to
//   the next); within a chunk, rows go in two blocks of 64, each streaming
//   q and k through shared memory in 16-wide dk tiles.  One k loop computes
//   the 64 x L scores (4 x 8 per thread), q.C for the block's columns (4 x 4
//   per thread, reading C from shared memory) and q.n, so q is read once;
//   the masked, decayed scores w go to shared memory (transposed), and a
//   second loop forms w.v over the causal range only;
// * the carry streams k in 64-row dk blocks, scaled by the key scales on the
//   way in, and updates C = old * C + (k * scale)^T v and n in place;
// * every shared-memory operand of the inner loops is read as float4; q, k and
//   v are read by strides (dk and dv contiguous), so the projections' layout
//   is taken as it is, with 64-bit offsets.
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

constexpr int THREADS = 256;
constexpr int BV = 64;           // value columns per block: its slice of C
constexpr int LMAX = 128;        // the longest chunk
constexpr int RB = 64;           // query rows per row block
constexpr int TK = 16;           // dk per streamed q / k tile
constexpr int KB = 64;           // dk rows per step of the state update
constexpr int QT_LD = RB + 4;    // leading dims of the transposed tiles
constexpr int KT_LD = LMAX + 4;  // (padded; multiples of 4 for float4)
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* ig;
  const float* fg;
  void* h;   // (B, H, S, dv), contiguous
  float* C;  // (B, H, dk, dv)
  float* n;  // (B, H, dk)
  float* m;  // (B, H)
  int H, S, dk, dv, L;
  long long q_sb, q_sh, q_ss;  // element strides of (B, H, S); dk / dv contiguous
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long i_sb, i_sh, i_ss;
  long long f_sb, f_sh, f_ss;
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

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void sts4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

// log(sigmoid(f)) in the stable form jax.nn.log_sigmoid computes
__device__ __forceinline__ float log_sigmoid(float f) {
  return fminf(f, 0.f) - log1pf(expf(-fabsf(f)));
}

// Shared-memory floats for a given dk (the layout below).
__host__ __device__ constexpr int smem_floats(int dk) {
  return dk * BV + LMAX * BV + LMAX * RB + TK * QT_LD + TK * KT_LD + dk + 5 * LMAX + 2 * RB + 4;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) mlstm_chunk_fwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const int dk = p.dk, L = p.L;
  float* Cs = reinterpret_cast<float*>(smem4);  // [dk][BV]: this block's slice of C
  float* Vs = Cs + dk * BV;                     // [LMAX][BV]: the chunk's v columns
  float* Ws = Vs + LMAX * BV;                   // [LMAX][RB]: w^T of a row block, then
                                                //   [LMAX][KB]: k * key scale in the carry
  float* Qt = Ws + LMAX * RB;                   // [TK][QT_LD]: q tile, transposed, scaled
  float* Kt = Qt + TK * QT_LD;                  // [TK][KT_LD]: k tile, transposed
  float* ns = Kt + TK * KT_LD;                  // [dk]: n
  float* bs = ns + dk;                          // [LMAX]: b = cumsum(log f)
  float* igs = bs + LMAX;                       // [LMAX]: input gate
  float* mts = igs + LMAX;                      // [LMAX]: m_t
  float* inters = mts + LMAX;                   // [LMAX]: exp(b + m_prev - m_t)
  float* kscs = inters + LMAX;                  // [LMAX]: key scales of the carry
  float* dens = kscs + LMAX;                    // [RB]: row sums of w
  float* qns = dens + RB;                       // [RB]: q.n
  float* scal = qns + RB;                       // [0] M, [1] exp(bC + m_prev - M)

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // 16 x 16 threads: 4 rows x (8 or 4) cols each
  const int bh = blockIdx.x;
  const long long b = bh / p.H, hh = bh % p.H;
  const int v0 = blockIdx.y * BV;
  const int nv = min(BV, p.dv - v0);  // live columns of this block (a multiple of 16)

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + hh * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hh * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hh * p.v_sh + v0;
  const float* ib = p.ig + b * p.i_sb + hh * p.i_sh;
  const float* fb = p.fg + b * p.f_sb + hh * p.f_sh;
  T* hb = static_cast<T*>(p.h) + (long long)bh * p.S * p.dv + v0;

  for (int i = tid; i < dk * BV; i += THREADS) Cs[i] = 0.f;
  for (int i = tid; i < dk; i += THREADS) ns[i] = 0.f;
  float m_prev = 0.f;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t0 = 0; t0 < p.S; t0 += L) {
    // ---- gates and the chunk's v columns ----
    if (tid < L) {
      igs[tid] = ib[(t0 + tid) * p.i_ss];
      bs[tid] = log_sigmoid(fb[(t0 + tid) * p.f_ss]);
    }
    for (int idx = tid; idx < LMAX * (BV / 4); idx += THREADS) {
      const int s = idx / (BV / 4), c4 = (idx % (BV / 4)) * 4;
      float4 val = zero4;
      if (s < L && c4 < nv) val = IO<T>::load4(vb + (t0 + s) * p.v_ss + c4);
      sts4(Vs + s * BV + c4, val);
    }
    __syncthreads();
    if (tid < 32) {  // b = inclusive cumsum of log f: 4 entries per lane, then a warp scan
      float x[4], run = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = tid * 4 + j;
        run += s < L ? bs[s] : 0.f;
        x[j] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float y = __shfl_up_sync(FULL, incl, off);
        if (tid >= off) incl += y;
      }
      float excl = __shfl_up_sync(FULL, incl, 1);
      if (tid == 0) excl = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (tid * 4 + j < L) bs[tid * 4 + j] = excl + x[j];
    }
    __syncthreads();
    if (tid < L) {  // the row stabilizer m_t: the max of the masked decay row
      const float bt = bs[tid];
      float mi = NEG_INF;
      for (int s = 0; s <= tid; ++s) mi = fmaxf(mi, (bt - bs[s]) + igs[s]);
      const float mt = fmaxf(mi, bt + m_prev);
      mts[tid] = mt;
      inters[tid] = expf((bt + m_prev) - mt);
    } else if (tid >= LMAX && tid < LMAX + 32) {  // the carry's M and key scales
      const int lane = tid - LMAX;
      const float bC = bs[L - 1];
      float mx = NEG_INF;
      for (int s = lane; s < L; s += 32) mx = fmaxf(mx, (bC - bs[s]) + igs[s]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float M = fmaxf(bC + m_prev, mx);
      for (int s = lane; s < L; s += 32) kscs[s] = expf(((bC - bs[s]) + igs[s]) - M);
      if (lane == 0) {
        scal[0] = M;
        scal[1] = expf((bC + m_prev) - M);
      }
    }
    __syncthreads();

    // ---- h, one block of RB rows at a time ----
    for (int r0 = 0; r0 < L; r0 += RB) {
      float acc[4][8], qc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) qc[i][j] = 0.f;
      }
      const int lr = tid / 4, lq = (tid % 4) * 4;  // tile loads: a row and 4 of its 16 columns
      float qn = 0.f;
      for (int k0 = 0; k0 < dk; k0 += TK) {
        {
          float4 val = zero4;
          if (r0 + lr < L) val = IO<T>::load4(qb + (t0 + r0 + lr) * p.q_ss + k0 + lq);
          Qt[(lq + 0) * QT_LD + lr] = val.x * p.scale;
          Qt[(lq + 1) * QT_LD + lr] = val.y * p.scale;
          Qt[(lq + 2) * QT_LD + lr] = val.z * p.scale;
          Qt[(lq + 3) * QT_LD + lr] = val.w * p.scale;
        }
#pragma unroll
        for (int rep = 0; rep < LMAX / 64; ++rep) {
          const int s = lr + 64 * rep;
          float4 val = zero4;
          if (s < L) val = IO<T>::load4(kb + (t0 + s) * p.k_ss + k0 + lq);
          Kt[(lq + 0) * KT_LD + s] = val.x;
          Kt[(lq + 1) * KT_LD + s] = val.y;
          Kt[(lq + 2) * KT_LD + s] = val.z;
          Kt[(lq + 3) * KT_LD + s] = val.w;
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < 4; ++j) qn += Qt[(lq + j) * QT_LD + lr] * ns[k0 + lq + j];
#pragma unroll
        for (int kk = 0; kk < TK; ++kk) {
          const float4 a = lds4(Qt + kk * QT_LD + ty * 4);
          const float4 k0v = lds4(Kt + kk * KT_LD + tx * 8);
          const float4 k1v = lds4(Kt + kk * KT_LD + tx * 8 + 4);
          const float4 cv = lds4(Cs + (k0 + kk) * BV + tx * 4);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float kv[8] = {k0v.x, k0v.y, k0v.z, k0v.w, k1v.x, k1v.y, k1v.z, k1v.w};
          const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], kv[j], acc[i][j]);
#pragma unroll
            for (int j = 0; j < 4; ++j) qc[i][j] = fmaf(av[i], cc[j], qc[i][j]);
          }
        }
        __syncthreads();
      }
      // q.n: the 4 partial sums of each row
      qn += __shfl_xor_sync(FULL, qn, 1);
      qn += __shfl_xor_sync(FULL, qn, 2);
      if (tid % 4 == 0) qns[lr] = qn;
      // w = (q.k) * exp(decay - m_t) on s <= t, else 0; its row sums
      float rs[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = r0 + ty * 4 + i;
        const float bt = t < L ? bs[t] : 0.f;
        const float mt = t < L ? mts[t] : 0.f;
        rs[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int s = tx * 8 + j;
          float w = 0.f;
          if (t < L && s <= t) w = acc[i][j] * expf(((bt - bs[s]) + igs[s]) - mt);
          acc[i][j] = w;
          rs[i] += w;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int off = 8; off > 0; off /= 2) rs[i] += __shfl_xor_sync(FULL, rs[i], off);
      }
      if (tx == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) dens[ty * 4 + i] = rs[i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sts4(Ws + (tx * 8 + j) * RB + ty * 4,
             make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]));
      __syncthreads();
      // num = w.v over the causal range s < r0 + RB
      float o[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
      }
      const int s_end = min(L, r0 + RB);
      for (int s = 0; s < s_end; ++s) {
        const float4 a = lds4(Ws + s * RB + ty * 4);
        const float4 bv = lds4(Vs + s * BV + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float vv[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) o[i][j] = fmaf(av[i], vv[j], o[i][j]);
        }
      }
      if (tx * 4 < nv) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = r0 + ty * 4 + i;
          if (t < L) {
            const float inter = inters[t];
            const float den = dens[ty * 4 + i] + inter * qns[ty * 4 + i];
            const float dd = fmaxf(fabsf(den), expf(-mts[t]));
            const float4 out = make_float4(
                (o[i][0] + inter * qc[i][0]) / dd, (o[i][1] + inter * qc[i][1]) / dd,
                (o[i][2] + inter * qc[i][2]) / dd, (o[i][3] + inter * qc[i][3]) / dd);
            IO<T>::store4(hb + (long long)(t0 + t) * p.dv + tx * 4, out);
          }
        }
      }
      __syncthreads();
    }

    // ---- carry: C = old * C + (k * scale)^T v, n = old * n + sum_s k * scale ----
    const float old = scal[1];
    for (int kb0 = 0; kb0 < dk; kb0 += KB) {
      const int nk = min(KB, dk - kb0);
      for (int idx = tid; idx < LMAX * (KB / 4); idx += THREADS) {
        const int s = idx / (KB / 4), c4 = (idx % (KB / 4)) * 4;
        float4 val = zero4;
        if (s < L && c4 < nk) val = scale4(IO<T>::load4(kb + (t0 + s) * p.k_ss + kb0 + c4), kscs[s]);
        sts4(Ws + s * KB + c4, val);
      }
      __syncthreads();
      {  // n: 4 threads per key column
        const int col = tid / 4, part = tid % 4;
        float sum = 0.f;
        for (int s = part; s < L; s += 4) sum += Ws[s * KB + col];
        sum += __shfl_xor_sync(FULL, sum, 1);
        sum += __shfl_xor_sync(FULL, sum, 2);
        if (part == 0 && col < nk) ns[kb0 + col] = old * ns[kb0 + col] + sum;
      }
      if (ty * 4 < nk) {
        float u[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) u[i][j] = 0.f;
        }
        for (int s = 0; s < L; ++s) {
          const float4 a = lds4(Ws + s * KB + ty * 4);
          const float4 bv = lds4(Vs + s * BV + tx * 4);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float vv[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) u[i][j] = fmaf(av[i], vv[j], u[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* cp = Cs + (kb0 + ty * 4 + i) * BV + tx * 4;
          const float4 c = lds4(cp);
          sts4(cp, make_float4(old * c.x + u[i][0], old * c.y + u[i][1], old * c.z + u[i][2],
                               old * c.w + u[i][3]));
        }
      }
      __syncthreads();
    }
    m_prev = scal[0];
  }

  // ---- the final state ----
  float* Cb = p.C + (long long)bh * dk * p.dv + v0;
  for (int idx = tid; idx < dk * (BV / 4); idx += THREADS) {
    const int r = idx / (BV / 4), c4 = (idx % (BV / 4)) * 4;
    if (c4 < nv) sts4(Cb + (long long)r * p.dv + c4, lds4(Cs + r * BV + c4));
  }
  if (blockIdx.y == 0) {
    for (int i = tid; i < dk; i += THREADS) p.n[(long long)bh * dk + i] = ns[i];
    if (tid == 0) p.m[bh] = m_prev;
  }
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)smem_floats(p.dk);
  auto kernel = mlstm_chunk_fwd_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * p.H, (p.dv + BV - 1) / BV);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest dk the shared-memory layout takes (C slice and n for dk rows).
int mlstm_chunk_max_dk() {
  int dk = 16;
  while (sizeof(float) * (size_t)smem_floats(dk + 16) <= 232448) dk += 16;
  return dk;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and h; the gates are float32).
// Strides are in elements.  Returns the cudaError_t of the launch (0 on
// success).
int mlstm_chunk_fwd(const void* q, const void* k, const void* v, const float* ig,
                    const float* fg, void* h, float* C, float* n, float* m, int dtype, int B,
                    int H, int S, int dk, int dv, int chunk, long long q_sb, long long q_sh,
                    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                    long long v_sb, long long v_sh, long long v_ss, long long i_sb,
                    long long i_sh, long long i_ss, long long f_sb, long long f_sh,
                    long long f_ss, float scale, int device, void* stream) {
  if (chunk < 1 || chunk > LMAX || S % chunk != 0 || dk % 16 != 0 || dv % 16 != 0 ||
      dk > mlstm_chunk_max_dk())
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Params p{q,    k,    v,    ig,   fg,   h,    C,    n,    m,    H,    S,    dk,
                 dv,   chunk, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, i_sb,
                 i_sh, i_ss, f_sb, f_sh, f_ss, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, B, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

const char* mlstm_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
