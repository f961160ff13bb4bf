// f32 matrix products for Hopper (sm_90a) on the tensor cores: 3xTF32 with
// wgmma, C = A . B in f32 accuracy, A (M x K) and B (K x N) read by strides.
//
// Replaces no TPU kernel: the JAX package leaves its matrix products to XLA
// (src/repro/models/layers.py, attention.py: ``x @ w``).  Added because the
// port's f32 products ran on cuBLAS's FFMA sgemm (TF32 off), which leaves the
// H100's tensor cores idle in the 58-84 % of a training step that goes to
// products.  The model layer's ``linear`` (../ops.py) sends the forward
// product and both backward products (dX = dY . W^T, dW = X^T . dY) here.
//
// What bounds it on an H100: operations.  3xTF32 takes three TF32 products
// per f32 product, so the bound is 3 * 2MNK / 494.7 TFLOP/s (164.9 TFLOP/s
// f32-accurate), against FFMA's 67 TFLOP/s.  Shared memory comes close
// behind: a TF32 wgmma with B from shared memory reads 64 B per clock at the
// tensor cores' rate, and the split below writes B's two parts into shared
// memory once more.  On an H100 80GB HBM3 (700 W) it runs at 51-58 % of the
// bound at olmo-1b's shapes; built with one TF32 product in place of three
// it takes 14 % less time, with no split 24 % less: no one part holds it.
// What the design does about it:
//
// * the split (../../csrc/mma_tf32x3.cuh): big = tf32(x) rounded to nearest,
//   small = tf32(x - big); a product is small_a.big_b + big_a.small_b +
//   big_a.big_b, the cross terms first.  The tensor cores' f32 accumulation
//   truncates, and K runs to 8,192: so each 32-deep k-block's three products
//   are taken from zero in a wgmma accumulator (12 wgmmas, the eight cross
//   terms first) and added to an f32 register total with an FADD (mma3_rn's
//   rule, per k-block);
// * A comes from registers (wgmma's RS form): a consumer loads its fragment
//   from the TMA tile in any layout (K- or M-major), splits it there, and
//   spends no shared-memory bandwidth on A's parts.  B must be K-major in
//   shared memory for a TF32 wgmma: a transform warpgroup reads B's TMA tile
//   (K- or N-major), splits it and writes big and small as K-major
//   128-byte-swizzled tiles, transposing an N-major tile in the same pass;
// * one persistent block per SM walks the 128 x 128 output tiles (grouped by
//   8 row tiles, so that a wave's operands stay in L2): warpgroup 0's first
//   thread keeps TMA loads of A and B (f32, 128-byte swizzle) in flight in a
//   ring of 4 stages, warpgroup 0 then splits B into a ring of 2 stages, and
//   warpgroups 1 and 2 each issue the wgmmas of 64 rows.  mbarriers hand the
//   stages on, so one tile's epilogue overlaps the next tile's loads;
// * the operand layouts of the three products are read by strides through
//   the TMA descriptors (Y = X.W: B N-major; dX: both K-major; dW: both
//   MN-major; the tied head's table^T: B K-major), never through a copy;
// * no split-K, no atomics: the same inputs give the same bits on every run.
//
// Shared memory: 4 x (16 + 16) KiB of raw A and B, 2 x (16 + 16) KiB of B's
// big and small parts, the barriers: 193 KiB of the SM's 227.

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <atomic>

#include "mma_tf32x3.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int RAW_STAGES = 4, CONV_STAGES = 2;
constexpr int TILE_BYTES = BM * BK * 4;  // 16 KiB, one operand's tile (BM == BN)
constexpr int SUB_BYTES = 32 * BK * 4;   // 4 KiB, a 32-wide box of an MN-major tile
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
constexpr int BAR_OFFSET = (RAW_STAGES + CONV_STAGES) * STAGE_BYTES;
constexpr int SMEM_BYTES = BAR_OFFSET + 16 * 8 + 1024;  // barriers, 1024-byte alignment
constexpr int THREADS = 384;
constexpr int GROUP_M = 8;
// arrivals: the transform warpgroup's 4 warps and the consumers' 8 free a raw
// stage; the transform's 4 fill a split stage; the consumers' 8 free it
constexpr uint32_t RAW_EMPTY_ARRIVALS = 12, CONV_FULL_ARRIVALS = 4, CONV_EMPTY_ARRIVALS = 8;

// ---- shared memory, barriers, TMA ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// byte offset of f32 element (row, col) in a tile of 128-byte rows as TMA's
// 128-byte swizzle lays it out: 16-byte chunk c of row r sits at chunk c ^ (r % 8)
__device__ __forceinline__ uint32_t sw128(int row, int col) {
  return row * 128 + ((((col >> 2) ^ row) & 7) << 4) + ((col & 3) << 2);
}

// ---- wgmma ----

// a K-major operand of 128-byte swizzled rows, 8-row groups 1024 bytes apart
// (the tile 1024-byte aligned); a k8 step further is 32 bytes, + 2 here
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// registers the asynchronous wgmma reads or writes stay put until its wait
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void pin(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// d (64 x 128, f32) = [d +] a (64 x 8, TF32 registers) . b (8 x 128, TF32,
// K-major in shared memory)
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], uint32_t a0, uint32_t a1,
                                                uint32_t a2, uint32_t a3, uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void split4(const float4 x, float4& big, float4& small) {
  uint32_t b, s;
  tf32x3::split<false>(x.x, b, s);
  big.x = __uint_as_float(b), small.x = __uint_as_float(s);
  tf32x3::split<false>(x.y, b, s);
  big.y = __uint_as_float(b), small.y = __uint_as_float(s);
  tf32x3::split<false>(x.z, b, s);
  big.z = __uint_as_float(b), small.z = __uint_as_float(s);
  tf32x3::split<false>(x.w, b, s);
  big.w = __uint_as_float(b), small.w = __uint_as_float(s);
}

// output tile `tile` of the grouped order -> (row tile, column tile)
__device__ __forceinline__ void tile_coords(int tile, int tiles_m, int tiles_n, int& tm,
                                            int& tn) {
  const int per_group = GROUP_M * tiles_n;
  const int group = tile / per_group;
  const int first = group * GROUP_M;
  const int rows = min(tiles_m - first, GROUP_M);
  const int in_group = tile - group * per_group;
  tm = first + in_group % rows;
  tn = in_group / rows;
}

// A_K: A is K-major (a row of A contiguous), else M-major.  B_K: B is K-major
// (a column of B contiguous), else N-major.  A K-major tile is one TMA box of
// 128 rows x 32 k; an MN-major tile four boxes of 32 k rows x 32 m (or n).
template <bool A_K, bool B_K>
__global__ void __launch_bounds__(THREADS, 1)
    tf32x3_wgmma_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                             const __grid_constant__ CUtensorMap map_b, float* __restrict__ c,
                             int M, int N, int K, long long ldc) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = smem_u32(smem);
  const uint32_t bars = s0 + BAR_OFFSET;
  auto raw_full = [&](int r) { return bars + 8 * r; };
  auto raw_empty = [&](int r) { return bars + 8 * (RAW_STAGES + r); };
  auto conv_full = [&](int s) { return bars + 8 * (2 * RAW_STAGES + s); };
  auto conv_empty = [&](int s) { return bars + 8 * (2 * RAW_STAGES + CONV_STAGES + s); };

  if (threadIdx.x == 0) {
    for (int r = 0; r < RAW_STAGES; ++r) {
      bar_init(raw_full(r), 1);
      bar_init(raw_empty(r), RAW_EMPTY_ARRIVALS);
    }
    for (int s = 0; s < CONV_STAGES; ++s) {
      bar_init(conv_full(s), CONV_FULL_ARRIVALS);
      bar_init(conv_empty(s), CONV_EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int tiles = tiles_m * tiles_n;
  const int kblocks = (K + BK - 1) / BK;
  const int my_tiles =
      static_cast<int>(blockIdx.x) < tiles ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int total = my_tiles * kblocks;  // k-blocks this block walks, all tiles in turn
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;

  if (wg == 0) {
    // ---- TMA producer (thread 0) and B's split into K-major big and small ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    auto produce = [&](int j) {
      const int r = j % RAW_STAGES;
      bar_wait(raw_empty(r), ((j / RAW_STAGES) & 1) ^ 1);
      bar_expect(raw_full(r), STAGE_BYTES);
      int tm, tn;
      tile_coords(blockIdx.x + (j / kblocks) * gridDim.x, tiles_m, tiles_n, tm, tn);
      const int k0 = (j % kblocks) * BK;
      const uint32_t a_dst = s0 + r * STAGE_BYTES, b_dst = a_dst + TILE_BYTES;
      if (A_K) {
        tma_load(a_dst, &map_a, raw_full(r), k0, tm * BM);
      } else {
#pragma unroll
        for (int q = 0; q < BM / 32; ++q)
          tma_load(a_dst + q * SUB_BYTES, &map_a, raw_full(r), tm * BM + 32 * q, k0);
      }
      if (B_K) {
        tma_load(b_dst, &map_b, raw_full(r), k0, tn * BN);
      } else {
#pragma unroll
        for (int q = 0; q < BN / 32; ++q)
          tma_load(b_dst + q * SUB_BYTES, &map_b, raw_full(r), tn * BN + 32 * q, k0);
      }
    };
    const bool producer = threadIdx.x == 0;
    if (producer)
      for (int j = 0; j < min(RAW_STAGES - 1, total); ++j) produce(j);
    for (int it = 0; it < total; ++it) {
      if (producer && it + RAW_STAGES - 1 < total) produce(it + RAW_STAGES - 1);
      __syncwarp();
      const int r = it % RAW_STAGES, s = it % CONV_STAGES;
      bar_wait(raw_full(r), (it / RAW_STAGES) & 1);
      bar_wait(conv_empty(s), ((it / CONV_STAGES) & 1) ^ 1);
      const uint8_t* raw_b = smem + r * STAGE_BYTES + TILE_BYTES;
      uint8_t* big = smem + (RAW_STAGES + s) * STAGE_BYTES;
      uint8_t* small = big + TILE_BYTES;
      if (B_K) {
        // the TMA tile is already K-major and swizzled as wgmma reads it
#pragma unroll
        for (int i = threadIdx.x; i < BN * BK / 4; i += 128) {
          float4 hi, lo;
          split4(*reinterpret_cast<const float4*>(raw_b + 16 * i), hi, lo);
          *reinterpret_cast<float4*>(big + 16 * i) = hi;
          *reinterpret_cast<float4*>(small + 16 * i) = lo;
        }
      } else {
        // warp w transposes box w (32 k x 32 n): lane = n, 4 k at a time
        const uint8_t* box = raw_b + warp * SUB_BYTES;
        const int n = 32 * warp + lane;
#pragma unroll
        for (int kc = 0; kc < BK / 4; ++kc) {
          float4 x, hi, lo;
          x.x = *reinterpret_cast<const float*>(box + sw128(4 * kc + 0, lane));
          x.y = *reinterpret_cast<const float*>(box + sw128(4 * kc + 1, lane));
          x.z = *reinterpret_cast<const float*>(box + sw128(4 * kc + 2, lane));
          x.w = *reinterpret_cast<const float*>(box + sw128(4 * kc + 3, lane));
          split4(x, hi, lo);
          *reinterpret_cast<float4*>(big + sw128(n, 4 * kc)) = hi;
          *reinterpret_cast<float4*>(small + sw128(n, 4 * kc)) = lo;
        }
      }
      // generic-proxy writes, read next by wgmma's async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        bar_arrive(conv_full(s));
        bar_arrive(raw_empty(r));
      }
    }
  } else {
    // ---- consumers: warpgroup 1 rows 0-63 of the tile, warpgroup 2 rows 64-127 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    const int g = lane / 4, t = lane % 4;
    const int m0 = 64 * (wg - 1) + 16 * warp + g;  // rows m0 and m0 + 8 of the tile
    float acc[64], part[64];
    uint32_t a_big[16], a_small[16];
    int it = 0;
    for (int lt = 0; lt < my_tiles; ++lt) {
      int tm, tn;
      tile_coords(blockIdx.x + lt * gridDim.x, tiles_m, tiles_n, tm, tn);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int kb = 0; kb < kblocks; ++kb, ++it) {
        const int r = it % RAW_STAGES, s = it % CONV_STAGES;
        bar_wait(raw_full(r), (it / RAW_STAGES) & 1);
        const uint8_t* raw_a = smem + r * STAGE_BYTES;
        // the A fragment of each k8 step (m64nNk8 TF32, as mma.m16n8k8's):
        // (m0, t), (m0 + 8, t), (m0, t + 4), (m0 + 8, t + 4)
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int m = m0 + 8 * (i & 1), k = 8 * j + t + 4 * (i >> 1);
            const uint32_t off =
                A_K ? sw128(m, k) : (m >> 5) * SUB_BYTES + sw128(k, m & 31);
            tf32x3::split<false>(*reinterpret_cast<const float*>(raw_a + off),
                                 a_big[4 * j + i], a_small[4 * j + i]);
          }
        }
        __syncwarp();
        if (lane == 0) bar_arrive(raw_empty(r));
        bar_wait(conv_full(s), (it / CONV_STAGES) & 1);
        __syncwarp();
        const uint32_t big = s0 + (RAW_STAGES + s) * STAGE_BYTES;
        const uint64_t d_big = desc_sw128(big), d_small = desc_sw128(big + TILE_BYTES);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          wgmma_m64n128k8(part, a_small[4 * j], a_small[4 * j + 1], a_small[4 * j + 2],
                          a_small[4 * j + 3], d_big + 2 * j, j > 0);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          wgmma_m64n128k8(part, a_big[4 * j], a_big[4 * j + 1], a_big[4 * j + 2],
                          a_big[4 * j + 3], d_small + 2 * j, 1);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          wgmma_m64n128k8(part, a_big[4 * j], a_big[4 * j + 1], a_big[4 * j + 2],
                          a_big[4 * j + 3], d_big + 2 * j, 1);
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int i = 0; i < 64; ++i) pin(part[i]);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          pin(a_big[i]);
          pin(a_small[i]);
        }
        __syncwarp();
        if (lane == 0) bar_arrive(conv_empty(s));
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
      }
      // epilogue: d[4i + 2h + e] is (row m0 + 8h, column 8i + 2t + e)
      const bool pairs = (ldc % 2) == 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = tm * BM + m0 + 8 * h;
        if (row >= M) continue;
        float* out = c + static_cast<long long>(row) * ldc;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int col = tn * BN + 8 * i + 2 * t;
          const float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
          if (pairs && col + 1 < N) {
            *reinterpret_cast<float2*>(out + col) = make_float2(v0, v1);
          } else {
            if (col < N) out[col] = v0;
            if (col + 1 < N) out[col + 1] = v1;
          }
        }
      }
    }
  }
}

// ---- host side ----

// libcuda's cuTensorMapEncodeTiled, found in the libcuda.so.1 the process has
// loaded, so that the library links against nothing but the CUDA runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled find_encode_tiled() {
  void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
  return lib == nullptr ? nullptr
                        : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
}

// looked up once per process (a function-local static: thread-safe)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = find_encode_tiled();
  return fn;
}

constexpr int ERR_NO_ENCODE = -1, ERR_TENSOR_MAP = -2;

// a 2-D f32 tensor of `outer` rows of `inner` contiguous elements, `stride`
// elements apart, read in boxes of 32 x box_outer (out of range: zeros)
int make_map(CUtensorMap* map, const float* base, long long inner, long long outer,
             long long stride, int box_outer) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride) * 4};
  const cuuint32_t box[2] = {32, static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

template <bool A_K, bool B_K>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, float* c, int M, int N, int K,
           long long ldc, int grid, int device, cudaStream_t stream) {
  // the attribute holds per device context: set once per device (a bit each;
  // two threads may both set it, which is harmless), on every call past 64
  static std::atomic<unsigned long long> ready{0};
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if ((ready.load(std::memory_order_acquire) & bit) == 0) {
    const cudaError_t err = cudaFuncSetAttribute(tf32x3_wgmma_gemm_kernel<A_K, B_K>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready.fetch_or(bit, std::memory_order_release);
  }
  tf32x3_wgmma_gemm_kernel<A_K, B_K><<<grid, THREADS, SMEM_BYTES, stream>>>(ma, mb, c, M, N, K,
                                                                            ldc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// C (M x N, row stride ldc) = A . B; A's element (m, k) at a[m * a_rs + k *
// a_cs], B's (k, n) at b[k * b_rs + n * b_cs], exactly one stride of each 1,
// the other a multiple of 4, the pointers 16-byte aligned (the wrapper
// checks).  `sms` persistent blocks at most.  Returns 0, a cudaError_t of the
// launch, or a negative code (tf32x3_gemm_error_string).
int tf32x3_gemm(const float* a, long long a_rs, long long a_cs, const float* b, long long b_rs,
                long long b_cs, float* c, long long ldc, int M, int N, int K, int sms,
                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool a_k = a_cs == 1, b_k = b_rs == 1;
  CUtensorMap ma, mb;
  int e = a_k ? make_map(&ma, a, K, M, a_rs, BM) : make_map(&ma, a, M, K, a_cs, 32);
  if (e != 0) return e;
  e = b_k ? make_map(&mb, b, K, N, b_cs, BN) : make_map(&mb, b, N, K, b_rs, 32);
  if (e != 0) return e;
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = tiles < sms ? tiles : sms;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_k && b_k) return launch<true, true>(ma, mb, c, M, N, K, ldc, grid, device, s);
  if (a_k) return launch<true, false>(ma, mb, c, M, N, K, ldc, grid, device, s);
  if (b_k) return launch<false, true>(ma, mb, c, M, N, K, ldc, grid, device, s);
  return launch<false, false>(ma, mb, c, M, N, K, ldc, grid, device, s);
}

const char* tf32x3_gemm_error_string(int err) {
  if (err == ERR_NO_ENCODE) return "cuTensorMapEncodeTiled not found in libcuda.so.1";
  if (err == ERR_TENSOR_MAP) return "cuTensorMapEncodeTiled refused an operand's layout";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
