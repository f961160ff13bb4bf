// Chunkwise-parallel mLSTM forward for Hopper (sm_90a) on the tensor cores,
// 3xTF32.
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
// L(L+1)/2 * (dk + dv) (the causal triangle of q.k^T and w.v) + 2*L*dk*dv
// (q.C and the C update) multiply-adds against (2*dk + 2*dv) * L * 4 bytes
// of q, k, v, h: at the serving shape (L = 128, dk = dv = 512) ~150 flops per
// byte.  The state update, q.C and w.v (89 % of the work there) run on the
// tensor cores in 3xTF32 (../../csrc/mma_tf32x3.cuh: each f32 operand split
// into two TF32 parts, three TF32 products, sums rounded to nearest in f32),
// which holds the reference's 2e-4 where one TF32 product would not; the
// bound is 3 * flops / 494.7 TFLOP/s (dense TF32), 2.5x tighter than f32
// FFMA's 67 TFLOP/s.
// What the design does about it:
//
// * every stabilizer quantity is a function of the gates alone (the prefix
//   sums b of log f, the row max m_t, inter, the carry's M, old and the key
//   scales), and only C and n carry data.  So the call is three launches on
//   one stream:
//   1. gate scan, grid B*H: per chunk, b (4 entries per lane, then a warp
//      scan: the order chip_smoke.py's _kernel_cumsum repeats), m_t, inter,
//      the key scales, old and M, to a small f32 scratch;
//   2. chunk states, grid (B*H, dk/64, dv/64) (2,048 blocks at the serving
//      shape): each block carries its 64 x 64 tile of C in mma accumulators
//      over the chunks, C <- old * C + (k * k_scale)^T v, streaming 64-row
//      slices of k and v through a two-stage cp.async ring, and n beside it
//      (the dv-tile-0 blocks).  It writes C and n at every chunk boundary to a
//      scratch the wrapper allocates: (B*H, S/L - 1, dk, dv) f32, 480 MiB at
//      the serving shape (written once and read once: ~0.3 ms of traffic at
//      3.35 TB/s, and that much more peak memory per call);
//   3. outputs, one block per (B*H, chunk, 64-row block), 1,024 at the serving
//      shape, fully parallel over chunks, the lightest (chunk 0, no carried
//      state) last: the causal scores q.k^T once per block, masked and
//      decayed into w in shared memory (never recomputed per dv slice), then
//      per 128-column dv tile h = (inter * q.C_prev + w.v) /
//      max(|sum(w) + inter * q.n_prev|, exp(-m_t)) on the tensor cores;
// * the scores, sum(w) and q.n are f32 FFMA (11 % of the work): with signed
//   q and k, den = sum(w) + inter * q.n cancels by orders of magnitude, and there only
//   scores that are the plain version's f32 chain over dk, in its order, hold
//   the 2e-4 (3xTF32 scores missed it there on the chip);
// * the route is mma.sync.m16n8k8 (TF32), not wgmma: the split lives in
//   registers between a fragment load and its mma, and the fragment loads
//   read any shared-memory layout (the state update's A is k^T, and C and v
//   are k-major B operands, which wgmma's TF32 form does not take).  bf16
//   inputs are exact in TF32, so their cross products are skipped;
// * tiles sit in shared memory in the inputs' own type, with leading
//   dimensions that keep the fragment loads free of bank conflicts; q, k and
//   v are read by strides (dk and dv contiguous), so the projections' layout
//   is taken as it is, with 64-bit offsets.
//
// The kernels allocate nothing.  The host function launches on the stream it
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

constexpr int THREADS = 128;  // 4 warps, every kernel
constexpr int LMAX = 128;     // the longest chunk
constexpr int MAX_DK = 576;   // n_prev of a chunk in shared memory (outputs pass)
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
  // scratch, contiguous f32: per (b, h) and row (B*H, S); per chunk (B*H, NC);
  // the states entering chunks 1..NC-1 (B*H, NC-1, dk, dv) and (B*H, NC-1, dk)
  float* gb;      // b = cumsum(log f) within the chunk
  float* gmt;     // m_t
  float* ginter;  // exp(b_t + m_prev - m_t)
  float* gksc;    // exp(b_C - b_s + i_s - M): the key scales of the carry
  float* gold;    // exp(b_C + m_prev - M)
  float* Cst;
  float* nst;
  int BH, H, S, dk, dv, L, NC;
  long long q_sb, q_sh, q_ss;  // element strides of (B, H, S); dk / dv contiguous
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long i_sb, i_sh, i_ss;
  long long f_sb, f_sh, f_ss;
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* base, int bh, int H, long long sb,
                                             long long sh) {
  return static_cast<const T*>(base) + (long long)(bh / H) * sb + (long long)(bh % H) * sh;
}

// log(sigmoid(f)) in the stable form jax.nn.log_sigmoid computes
__device__ __forceinline__ float log_sigmoid(float f) {
  return fminf(f, 0.f) - log1pf(expf(-fabsf(f)));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const float2 lo = ld2(p), hi = ld2(p + 2);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// 1. Gate scan: one block of 128 threads per (b, h), the chunks in order.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) mlstm_gate_scan_kernel(const Params p) {
  __shared__ float bs[LMAX], igs[LMAX], scal[1];
  const int bh = blockIdx.x, tid = threadIdx.x, L = p.L;
  const float* ib = p.ig + (long long)(bh / p.H) * p.i_sb + (long long)(bh % p.H) * p.i_sh;
  const float* fb = p.fg + (long long)(bh / p.H) * p.f_sb + (long long)(bh % p.H) * p.f_sh;
  const long long row0 = (long long)bh * p.S;
  float m_prev = 0.f;
  for (int c = 0; c < p.NC; ++c) {
    const int t0 = c * L;
    if (tid < L) {
      igs[tid] = ib[(t0 + tid) * p.i_ss];
      bs[tid] = log_sigmoid(fb[(t0 + tid) * p.f_ss]);
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
      p.gb[row0 + t0 + tid] = bt;
      p.gmt[row0 + t0 + tid] = mt;
      p.ginter[row0 + t0 + tid] = expf((bt + m_prev) - mt);
    }
    if (tid < 32) {  // the carry's M, key scales and old
      const float bC = bs[L - 1];
      float mx = NEG_INF;
      for (int s = tid; s < L; s += 32) mx = fmaxf(mx, (bC - bs[s]) + igs[s]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float M = fmaxf(bC + m_prev, mx);
      for (int s = tid; s < L; s += 32) p.gksc[row0 + t0 + s] = expf(((bC - bs[s]) + igs[s]) - M);
      if (tid == 0) {
        p.gold[(long long)bh * p.NC + c] = expf((bC + m_prev) - M);
        scal[0] = M;
      }
    }
    __syncthreads();
    m_prev = scal[0];
  }
  if (tid == 0) p.m[bh] = m_prev;
}

// ---------------------------------------------------------------------------
// 2. Chunk states: one block per (b, h) and 64 x 64 tile of C, the chunks in
//    order; 64-row slices of k and v through a two-stage cp.async ring.
// ---------------------------------------------------------------------------

constexpr int ST = 64;          // dk rows and dv columns of a block's C tile; rows per slice
constexpr int ST_LD = ST + 4;   // k-major fragment loads (4 mod 32)

template <typename T>
struct StatesStage {
  T k[ST * ST_LD];  // [row s][dk]
  T v[ST * ST_LD];  // [row s][dv]
  float ksc[ST];    // the key scales of the slice's rows (0 past the chunk)
};

// Issue the copies of slice `sub` of chunk c into a stage; rows past the
// chunk and columns past dk / dv are zero-filled.
template <typename T>
__device__ __forceinline__ void states_issue(StatesStage<T>& st, const Params& p, const T* kb,
                                             const T* vb, const float* kscb, int c, int sub,
                                             int k0, int v0) {
  const int nrows = min(ST, p.L - sub * ST);
  const long long s0 = (long long)c * p.L + sub * ST;
  for (int idx = threadIdx.x; idx < ST * (ST / 4); idx += THREADS) {
    const int r = idx / (ST / 4), c4 = (idx % (ST / 4)) * 4;
    const bool row_ok = r < nrows;
    const bool kok = row_ok && k0 + c4 < p.dk, vok = row_ok && v0 + c4 < p.dv;
    const long long s = s0 + r;
    cp_async4(st.k + r * ST_LD + c4, kok ? kb + s * p.k_ss + k0 + c4 : kb, kok);
    cp_async4(st.v + r * ST_LD + c4, vok ? vb + s * p.v_ss + v0 + c4 : vb, vok);
  }
  if (threadIdx.x < ST) st.ksc[threadIdx.x] = threadIdx.x < nrows ? kscb[s0 + threadIdx.x] : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 3) mlstm_states_kernel(const Params p) {
  constexpr bool EX = std::is_same<T, __nv_bfloat16>::value;  // k, v exact in TF32
  extern __shared__ float4 smem4[];
  StatesStage<T>* ring = reinterpret_cast<StatesStage<T>*>(smem4);
  const int bh = blockIdx.x, k0 = blockIdx.y * ST, v0 = blockIdx.z * ST;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wm = warp / 2, wn = warp % 2;  // each warp: 32 dk rows x 32 dv columns of C
  const T* kb = head_ptr<T>(p.k, bh, p.H, p.k_sb, p.k_sh);
  const T* vb = head_ptr<T>(p.v, bh, p.H, p.v_sb, p.v_sh);
  const float* kscb = p.gksc + (long long)bh * p.S;
  const bool with_n = blockIdx.z == 0 && threadIdx.x < ST;  // n: thread i carries n[k0 + i]

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  float nn = 0.f;

  const int nsub = (p.L + ST - 1) / ST, total = p.NC * nsub;
  states_issue(ring[0], p, kb, vb, kscb, 0, 0, k0, v0);
  cp_async_commit();
  for (int u = 0; u < total; ++u) {
    const int c = u / nsub, sub = u - c * nsub;
    if (u + 1 < total)
      states_issue(ring[(u + 1) & 1], p, kb, vb, kscb, (u + 1) / nsub, (u + 1) % nsub, k0, v0);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (sub == 0) {  // C <- old * C at the chunk's start
      const float old = p.gold[(long long)bh * p.NC + c];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] *= old;
      nn *= old;
    }
    const StatesStage<T>& st = ring[u & 1];
    // C += (k * k_scale)^T v over the slice's 64 rows
#pragma unroll 2
    for (int ks = 0; ks < ST / 8; ++ks) {
      const float s_lo = st.ksc[ks * 8 + 2 * t], s_hi = st.ksc[ks * 8 + 2 * t + 1];
      FragA a[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float x[4];
        load_a_cols(x, st.k + ks * 8 * ST_LD + wm * 32 + mt * 16, ST_LD);
        x[0] *= s_lo;
        x[1] *= s_lo;
        x[2] *= s_hi;
        x[3] *= s_hi;
        split_a<false>(a[mt], x);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float y[2];
        load_b_cols(y, st.v + ks * 8 * ST_LD + wn * 32 + nt * 8, ST_LD);
        FragB b;
        split_b<EX>(b, y);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma3<false, EX>(acc[mt][nt], a[mt], b);
      }
    }
    if (with_n) {  // n += sum_s k * k_scale, f32, in 8 partial sums of 8 rows
      float part[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        part[i] = 0.f;
#pragma unroll
        for (int r = i * 8; r < i * 8 + 8; ++r)
          part[i] += ld1(st.k + r * ST_LD + threadIdx.x) * st.ksc[r];
      }
      nn += ((part[0] + part[1]) + (part[2] + part[3])) +
            ((part[4] + part[5]) + (part[6] + part[7]));
    }
    if (sub == nsub - 1) {  // the chunk's end: the state entering chunk c + 1, or the final one
      const bool last = c == p.NC - 1;
      float* Cd = last ? p.C + (long long)bh * p.dk * p.dv
                       : p.Cst + ((long long)bh * (p.NC - 1) + c) * p.dk * p.dv;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = k0 + wm * 32 + mt * 16 + g;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = v0 + wn * 32 + nt * 8 + 2 * t;
          if (col < p.dv) {
            if (row < p.dk) st2(Cd + (long long)row * p.dv + col, acc[mt][nt][0], acc[mt][nt][1]);
            if (row + 8 < p.dk)
              st2(Cd + (long long)(row + 8) * p.dv + col, acc[mt][nt][2], acc[mt][nt][3]);
          }
        }
      }
      if (with_n && k0 + (int)threadIdx.x < p.dk) {
        float* nd = last ? p.n + (long long)bh * p.dk
                         : p.nst + ((long long)bh * (p.NC - 1) + c) * p.dk;
        nd[k0 + threadIdx.x] = nn;
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
}

// ---------------------------------------------------------------------------
// 3. Outputs: one block per (b, h), chunk and 64-row block of the chunk.
//    A ring of jobs, each one k tile through a two-stage cp.async ring:
//    the scores (per 64-key tile, over dk), then per 128-column dv tile
//    q.C_prev (over dk) and w.v (over the block's causal keys).
// ---------------------------------------------------------------------------

constexpr int RB = 64;         // rows per block, 32 per warp row
constexpr int KT = 32;         // dk (or keys) per streamed tile
constexpr int QLD = KT + 8;    // q tiles: k-contiguous fragment loads (8 mod 32)
constexpr int KLD = KT + 4;    // k tiles of the scores: 16-byte loads by 8 keys (4 mod 32)
constexpr int DT = 128;        // dv columns per output tile, 64 per warp column
constexpr int BLD = DT + 4;    // C_prev and v tiles: k-major loads (4 mod 32)
constexpr int WLD = LMAX + 8;  // w: k-contiguous loads
// a ring stage: a (RB x QLD) q tile, then a (64 x KLD) k tile or a
// (KT x BLD) C_prev or v tile, sized for f32
constexpr int STAGE_B_OFF = RB * QLD * 4;
constexpr int STAGE_BYTES = STAGE_B_OFF + KT * BLD * 4;

struct OutSmem {
  float w[RB * WLD];  // the block's rows of w = (q.k^T) * decay, masked
  float bs[LMAX], igs[LMAX];  // the chunk's b and input gates (keys)
  float mts[RB], inters[RB], dds[RB];  // per row: m_t, inter, the divisor
  float rsum[RB * 2];  // per row: sum(w) over each 64-key tile
  float nprev[MAX_DK];
};

constexpr size_t OUT_SMEM = 2 * STAGE_BYTES + sizeof(OutSmem);

struct Job {
  int kind;  // 0 scores, 1 q.C_prev, 2 w.v
  int a, b;  // scores: key tile, dk tile; q.C: dv tile, dk tile; w.v: dv tile, key tile
};

struct OutBlock {
  int bh, c, r0, nrows, s_end;  // rows [r0, r0 + nrows) of chunk c; keys [0, s_end)
  int ndk, nkey, ndv, nkv;      // dk tiles, 64-key score tiles, dv tiles, 32-key w.v tiles
  int n_scores, per_dv;         // jobs of the scores; jobs per dv tile
};

__device__ __forceinline__ Job job_at(const OutBlock& o, int j) {
  if (j < o.n_scores) return {0, j / o.ndk, j % o.ndk};
  j -= o.n_scores;
  const int dvt = j / o.per_dv, r = j % o.per_dv;
  const int nqc = o.c > 0 ? o.ndk : 0;
  return r < nqc ? Job{1, dvt, r} : Job{2, dvt, r - nqc};
}

template <typename T>
__device__ __forceinline__ void out_issue(char* stage, const Params& p, const OutBlock& o,
                                          const Job jb, const T* qb, const T* kb,
                                          const T* vb) {
  T* A = reinterpret_cast<T*>(stage);
  const long long t_base = (long long)o.c * p.L;
  if (jb.kind != 2) {  // the q tile: rows of the block, dk columns [32 jb.b, +32)
    const int d0 = jb.b * KT;
    for (int idx = threadIdx.x; idx < RB * (KT / 4); idx += THREADS) {
      const int r = idx / (KT / 4), c4 = (idx % (KT / 4)) * 4;
      const bool ok = r < o.nrows && d0 + c4 < p.dk;
      cp_async4(A + r * QLD + c4, ok ? qb + (t_base + o.r0 + r) * p.q_ss + d0 + c4 : qb, ok);
    }
  }
  if (jb.kind == 0) {  // the k tile: keys [64 jb.a, +64) of the chunk
    T* Kt = reinterpret_cast<T*>(stage + STAGE_B_OFF);
    const int d0 = jb.b * KT, s0 = jb.a * 64;
    for (int idx = threadIdx.x; idx < 64 * (KT / 4); idx += THREADS) {
      const int r = idx / (KT / 4), c4 = (idx % (KT / 4)) * 4;
      const bool ok = s0 + r < p.L && d0 + c4 < p.dk;
      cp_async4(Kt + r * KLD + c4, ok ? kb + (t_base + s0 + r) * p.k_ss + d0 + c4 : kb, ok);
    }
  } else if (jb.kind == 1) {  // C_prev rows [32 jb.b, +32), dv columns [128 jb.a, +128)
    float* Ct = reinterpret_cast<float*>(stage + STAGE_B_OFF);
    const float* Cb = p.Cst + ((long long)o.bh * (p.NC - 1) + o.c - 1) * p.dk * p.dv;
    const int d0 = jb.b * KT, v0 = jb.a * DT;
    for (int idx = threadIdx.x; idx < KT * (DT / 4); idx += THREADS) {
      const int r = idx / (DT / 4), c4 = (idx % (DT / 4)) * 4;
      const bool ok = d0 + r < p.dk && v0 + c4 < p.dv;
      cp_async4(Ct + r * BLD + c4, ok ? Cb + (long long)(d0 + r) * p.dv + v0 + c4 : Cb, ok);
    }
  } else {  // v rows: keys [32 jb.b, +32), dv columns [128 jb.a, +128)
    T* Vt = reinterpret_cast<T*>(stage + STAGE_B_OFF);
    const int s0 = jb.b * KT, v0 = jb.a * DT;
    for (int idx = threadIdx.x; idx < KT * (DT / 4); idx += THREADS) {
      const int r = idx / (DT / 4), c4 = (idx % (DT / 4)) * 4;
      const bool ok = s0 + r < p.L && v0 + c4 < p.dv;
      cp_async4(Vt + r * BLD + c4, ok ? vb + (t_base + s0 + r) * p.v_ss + v0 + c4 : vb, ok);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) mlstm_outputs_kernel(const Params p) {
  constexpr bool EX = std::is_same<T, __nv_bfloat16>::value;  // q, k, v exact in TF32
  extern __shared__ float4 smem4[];
  char* ring = reinterpret_cast<char*>(smem4);
  OutSmem& sm = *reinterpret_cast<OutSmem*>(ring + 2 * STAGE_BYTES);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wm = warp / 2, wn = warp % 2;
  const int tid = threadIdx.x;

  // the heaviest blocks first: chunk 0 (no carried state) last, then the
  // later row blocks (more causal keys) before the earlier
  const int nrb = (p.L + RB - 1) / RB;
  OutBlock o;
  o.bh = blockIdx.x % p.BH;
  {
    const int rank = blockIdx.x / p.BH;
    o.c = p.NC - 1 - rank / nrb;
    o.r0 = (nrb - 1 - rank % nrb) * RB;
  }
  o.nrows = min(RB, p.L - o.r0);
  o.s_end = o.r0 + o.nrows;
  o.ndk = (p.dk + KT - 1) / KT;
  o.nkey = (o.s_end + 63) / 64;
  o.ndv = (p.dv + DT - 1) / DT;
  o.nkv = (o.s_end + KT - 1) / KT;
  o.n_scores = o.nkey * o.ndk;
  o.per_dv = (o.c > 0 ? o.ndk : 0) + o.nkv;
  const int n_jobs = o.n_scores + o.ndv * o.per_dv;

  const T* qb = head_ptr<T>(p.q, o.bh, p.H, p.q_sb, p.q_sh);
  const T* kb = head_ptr<T>(p.k, o.bh, p.H, p.k_sb, p.k_sh);
  const T* vb = head_ptr<T>(p.v, o.bh, p.H, p.v_sb, p.v_sh);
  const long long row0 = (long long)o.bh * p.S + (long long)o.c * p.L;  // the chunk's first row

  out_issue<T>(ring, p, o, job_at(o, 0), qb, kb, vb);
  cp_async_commit();
  // gates of the chunk and the carried n while the first tile arrives
  const float* ib = p.ig + (long long)(o.bh / p.H) * p.i_sb + (long long)(o.bh % p.H) * p.i_sh;
  if (tid < p.L) {
    sm.bs[tid] = p.gb[row0 + tid];
    sm.igs[tid] = ib[((long long)o.c * p.L + tid) * p.i_ss];
  }
  if (tid < RB) {
    const bool ok = tid < o.nrows;
    sm.mts[tid] = ok ? p.gmt[row0 + o.r0 + tid] : 0.f;
    sm.inters[tid] = ok ? p.ginter[row0 + o.r0 + tid] : 0.f;
  }
  if (o.c > 0) {
    const float* nb = p.nst + ((long long)o.bh * (p.NC - 1) + o.c - 1) * p.dk;
    for (int i = tid; i < p.dk; i += THREADS) sm.nprev[i] = nb[i];
  }
  float qn = 0.f;  // q.n_prev: thread tid sums columns [16 (tid % 2), +16) of row tid / 2

  // one ring step: the next job's copies in flight, this job's arrived
  auto step_in = [&](int j) -> const char* {
    if (j + 1 < n_jobs)
      out_issue<T>(ring + ((j + 1) & 1) * STAGE_BYTES, p, o, job_at(o, j + 1), qb, kb, vb);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    return ring + (j & 1) * STAGE_BYTES;
  };

  // ---- the scores, f32 FFMA: row r = ty + 16 i, key s = 64 a + tx + 8 j.  Each
  // score is one FFMA chain over dk in order, the plain version's order of
  // additions: den = sum(w) + ... cancels over signed scores by orders of magnitude,
  // and only the same f32 chain holds the 2e-4 there ----
  {
    const int ty = tid / 8, tx = tid % 8;
    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
    for (int j = 0; j < o.n_scores; ++j) {
      const Job jb = job_at(o, j);
      const char* stage = step_in(j);
      const T* Qt = reinterpret_cast<const T*>(stage);
      const T* Kt = reinterpret_cast<const T*>(stage + STAGE_B_OFF);
#pragma unroll 2
      for (int k4 = 0; k4 < KT / 4; ++k4) {
        float a[4][4], b[8][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 x = ld4(Qt + (ty + 16 * i) * QLD + k4 * 4);
          a[i][0] = x.x * p.scale;
          a[i][1] = x.y * p.scale;
          a[i][2] = x.z * p.scale;
          a[i][3] = x.w * p.scale;
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float4 x = ld4(Kt + (tx + 8 * jj) * KLD + k4 * 4);
          b[jj][0] = x.x;
          b[jj][1] = x.y;
          b[jj][2] = x.z;
          b[jj][3] = x.w;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) sc[i][jj] = fmaf(a[i][kk], b[jj][kk], sc[i][jj]);
      }
      if (jb.a == 0 && o.c > 0) {  // q.n_prev, f32 FFMA, from the same q tile
        const int r = tid / 2, c0 = (tid % 2) * 16;
        float part[4] = {0.f, 0.f, 0.f, 0.f};  // short sums: den may cancel
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int d = jb.b * KT + c0 + i;
          if (d < p.dk)
            part[i % 4] = fmaf(ld1(Qt + r * QLD + c0 + i) * p.scale, sm.nprev[d], part[i % 4]);
        }
        qn += (part[0] + part[1]) + (part[2] + part[3]);
      }
      if (jb.b == o.ndk - 1) {  // the key tile's last dk tile: w = scores * decay, masked
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty + 16 * i;
          const int tt = o.r0 + r;  // the row within the chunk
          const float bt = sm.bs[min(tt, p.L - 1)], mt_t = sm.mts[r];
          float rs = 0.f;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int s = jb.a * 64 + tx + 8 * jj;
            const float w = tt < p.L && s <= tt
                                ? sc[i][jj] * expf(((bt - sm.bs[s]) + sm.igs[s]) - mt_t)
                                : 0.f;
            sm.w[r * WLD + s] = w;
            rs += w;
            sc[i][jj] = 0.f;
          }
          // the row's sum over this key tile: its 8 threads' partials
          rs += __shfl_xor_sync(FULL, rs, 1);
          rs += __shfl_xor_sync(FULL, rs, 2);
          rs += __shfl_xor_sync(FULL, rs, 4);
          if (tx == 0) sm.rsum[r * 2 + jb.a] = rs;
        }
        if (jb.a == o.nkey - 1) {  // w is complete: the divisor of each row
          __syncthreads();
          const int r = tid / 2;
          const float sum = o.nkey == 2 ? sm.rsum[r * 2] + sm.rsum[r * 2 + 1] : sm.rsum[r * 2];
          const float qn_r = qn + __shfl_xor_sync(FULL, qn, 1);
          if (tid % 2 == 0) {
            const float den = sum + sm.inters[r] * qn_r;
            sm.dds[r] = fmaxf(fabsf(den), expf(-sm.mts[r]));
          }
        }
      }
      __syncthreads();  // this stage is consumed before it is refilled
    }
  }

  // ---- the outputs: rows [32 wm, +32) x dv columns [128 jb.a + 64 wn, +64) on
  // the tensor cores, summed to nearest in acc (mma3_rn; the cross terms in
  // `part`, 32 columns at a time, added at the tile's end) ----
  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  for (int j = o.n_scores; j < n_jobs; ++j) {
    const Job jb = job_at(o, j);
    const char* stage = step_in(j);
    const T* Qt = reinterpret_cast<const T*>(stage);
    const bool qc = jb.kind == 1;
    const T* Bt = reinterpret_cast<const T*>(stage + STAGE_B_OFF);
    const float* Ct = reinterpret_cast<const float*>(stage + STAGE_B_OFF);
#pragma unroll
    for (int hn = 0; hn < 2; ++hn) {
      float part[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
#pragma unroll 1  // k steps one at a time: fully unrolled, acc, part and the
                  // fragments of all four exceed the 255 registers
      for (int ks = 0; ks < KT / 8; ++ks) {
        FragA a[2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float x[4];
          if (qc) {
            load_a_rows(x, Qt + (wm * 32 + mt * 16) * QLD + ks * 8, QLD);
#pragma unroll
            for (int e = 0; e < 4; ++e) x[e] *= p.scale;
          } else {
            load_a_rows(x, sm.w + (wm * 32 + mt * 16) * WLD + jb.b * KT + ks * 8, WLD);
          }
          split_a<false>(a[mt], x);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = wn * 64 + (hn * 4 + nt) * 8;
          float y[2];
          FragB b;
          if (qc) {
            load_b_cols(y, Ct + ks * 8 * BLD + col, BLD);
            split_b<false>(b, y);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              mma3_rn<false, false>(acc[mt][hn * 4 + nt], part[mt][nt], a[mt], b);
          } else {
            load_b_cols(y, Bt + ks * 8 * BLD + col, BLD);
            split_b<EX>(b, y);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              mma3_rn<false, EX>(acc[mt][hn * 4 + nt], part[mt][nt], a[mt], b);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][hn * 4 + nt][e] += part[mt][nt][e];
    }
    if (qc && jb.b == o.ndk - 1) {  // inter * q.C_prev, before w.v adds to it
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float in_lo = sm.inters[wm * 32 + mt * 16 + g];
        const float in_hi = sm.inters[wm * 32 + mt * 16 + g + 8];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          acc[mt][nt][0] *= in_lo;
          acc[mt][nt][1] *= in_lo;
          acc[mt][nt][2] *= in_hi;
          acc[mt][nt][3] *= in_hi;
        }
      }
    }
    if (!qc && jb.b == o.nkv - 1) {  // the dv tile is complete: h = num / divisor
      T* hb = static_cast<T*>(p.h) + (row0 + o.r0) * p.dv;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wm * 32 + mt * 16 + g + 8 * half;
          if (r < o.nrows) {
            const float dd = sm.dds[r];
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              const int col = jb.a * DT + wn * 64 + nt * 8 + 2 * t;
              if (col < p.dv)
                st2(hb + (long long)r * p.dv + col, acc[mt][nt][2 * half] / dd,
                    acc[mt][nt][2 * half + 1] / dd);
            }
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  mlstm_gate_scan_kernel<<<p.BH, THREADS, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t st_smem = 2 * sizeof(StatesStage<T>);
  err = cudaFuncSetAttribute(mlstm_states_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)st_smem);
  if (err != cudaSuccess) return err;
  const dim3 st_grid(p.BH, (p.dk + ST - 1) / ST, (p.dv + ST - 1) / ST);
  mlstm_states_kernel<T><<<st_grid, THREADS, st_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(mlstm_outputs_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)OUT_SMEM);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)p.BH * p.NC * ((p.L + RB - 1) / RB);
  if (blocks >= (1ll << 31)) return cudaErrorInvalidConfiguration;
  mlstm_outputs_kernel<T><<<(unsigned)blocks, THREADS, OUT_SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest dk the kernels take (n_prev of a chunk in shared memory).
int mlstm_chunk_max_dk() { return MAX_DK; }

// The float32 scratch of one call: offsets (in floats, each a multiple of 64,
// so that every region is 256-byte aligned for the 16-byte copies) of b,
// m_t, inter, the key scales (B*H*S each), old (B*H*NC), the states entering
// chunks 1..NC-1, C (B*H*(NC-1)*dk*dv) and n (B*H*(NC-1)*dk), NC = S / chunk,
// written to offsets[0..6]; returns the total.
long long mlstm_chunk_scratch_layout(int B, int H, int S, int dk, int dv, int chunk,
                                     long long* offsets) {
  const long long bh = (long long)B * H, nc = S / chunk;
  const long long sizes[7] = {bh * S, bh * S, bh * S, bh * S, bh * nc,
                              bh * (nc - 1) * dk * dv, bh * (nc - 1) * dk};
  long long at = 0;
  for (int i = 0; i < 7; ++i) {
    offsets[i] = at;
    at += (sizes[i] + 63) / 64 * 64;
  }
  return at;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and h; the gates are float32).
// Strides are in elements; scratch as mlstm_chunk_scratch_layout lays it
// out.  Returns the cudaError_t of the launches (0 on success).
int mlstm_chunk_fwd(const void* q, const void* k, const void* v, const float* ig,
                    const float* fg, void* h, float* C, float* n, float* m, float* scratch,
                    int dtype, int B, int H, int S, int dk, int dv, int chunk, long long q_sb,
                    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                    long long i_sb, long long i_sh, long long i_ss, long long f_sb,
                    long long f_sh, long long f_ss, float scale, int device, void* stream) {
  if (chunk < 1 || chunk > LMAX || S % chunk != 0 || dk % 16 != 0 || dv % 16 != 0 ||
      dk < 16 || dk > MAX_DK || dv < 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  long long off[7];
  mlstm_chunk_scratch_layout(B, H, S, dk, dv, chunk, off);
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.ig = ig;
  p.fg = fg;
  p.h = h;
  p.C = C;
  p.n = n;
  p.m = m;
  p.gb = scratch + off[0];
  p.gmt = scratch + off[1];
  p.ginter = scratch + off[2];
  p.gksc = scratch + off[3];
  p.gold = scratch + off[4];
  p.Cst = scratch + off[5];
  p.nst = scratch + off[6];
  p.BH = B * H;
  p.H = H;
  p.S = S;
  p.dk = dk;
  p.dv = dv;
  p.L = chunk;
  p.NC = S / chunk;
  p.q_sb = q_sb, p.q_sh = q_sh, p.q_ss = q_ss;
  p.k_sb = k_sb, p.k_sh = k_sh, p.k_ss = k_ss;
  p.v_sb = v_sb, p.v_sh = v_sh, p.v_ss = v_ss;
  p.i_sb = i_sb, p.i_sh = i_sh, p.i_ss = i_ss;
  p.f_sb = f_sb, p.f_sh = f_sh, p.f_ss = f_ss;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}

const char* mlstm_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
