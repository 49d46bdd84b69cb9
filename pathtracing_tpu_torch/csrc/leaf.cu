// The leaf-test micro-benchmark (K4) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of tools/bench_mxu_leaf.py (called
// through `run_mode`): one block, so one SM, loops n_iter leaf tests of K2
// triangles for 128 rays over tables resident in shared memory (no
// traversal), in eight modes that each compute what the TPU mode does:
//   vpu       scalar Moller-Trumbore (trace_common.cuh::test_leaf),
//             loop-carried best = min(best, tbest + 1e-7) (the test is
//             gated t < best);
//   mxu_hi    the determinant form: q = A [128,16] x B [16, 4*K2] gives
//             det, t*det, u*det, v*det per (ray, triangle) on the tensor
//             cores in 3xTF32: a = a_hi + a_lo, b = b_hi + b_lo,
//             q = a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, the f32-faithful split
//             (Hopper has no f32 tensor-core mode: this is the analog of
//             precision=HIGHEST);
//   mxu_3x    the manual bf16x3 split (hi = bf16(x), lo = bf16(x - hi);
//             ah*bh + ah*bl + al*bh);
//   mxu_1x    one bf16 pass (the accuracy-floor reference);
//   vpu_rec   MT plus the argmin / min hit recording: the test is gated
//             t < best + 1e-7 and a strictly nearer hit replaces best;
//   vpu_cond  vpu_rec with each test behind a runtime per-iteration gate;
//   vpu_dma   vpu_cond over blocks streamed from a global [512*K2] row
//             table into shared memory, double-buffered with cp.async;
//   vpu_while the 16-child nearest-first selection loop: per visit 16
//             child blocks are fetched with one cp.async group each, and
//             the children are tested in entry order, each waiting for its
//             own group only.
// The loop carries `best` from one iteration to the next, so the work
// cannot be spread over SMs without a grid-wide sync per iteration: the
// question K4 answers is the per-SM cost of a child test in each form.
//
// Bound on the H100: the work is compute only (the tables are read once):
// per iteration 128 x K2 triangle tests, ~45 fp32 operations each in the
// scalar modes (67 TFLOP/s), or a 2 x 128 x 16 x 4K2 product per tensor
// pass (3 passes TF32 at 495 TFLOP/s, 3 or 1 bf16 at 989) plus ~14 fp32
// operations per pair of post-processing.  One block runs on one of the
// 132 SMs, so the kernel cannot come within 132x of that whole-card bound
// (the one-SM bound is the card bound x 132).
//
// Design.
//   * Scalar modes: W = LEAF_LANES lanes per ray (8, chosen by the interleaved
//     A/B of bench_leaf over builds of 1, 2, 4 and 8; the group primitives of
//     group_walk.cuh), a block of 128 x W threads.  Lane j tests triangles j,
//     j + W, ... of the block (neighbouring lanes read neighbouring 48-byte
//     rows of shared memory) and the group reduces (t, least slot), so the
//     result equals the one-thread test bit for bit; every lane holds the
//     loop-carried best.  One ray per thread gave 4 warps on 4 schedulers,
//     each a chain of dependent loads and arithmetic; W lanes give 4W warps.
//     The streamed modes keep their schedule (double buffering; 16 child
//     groups waited in order) with the whole block copying.
//   * Tensor-core modes: MXU_WGS warpgroups (four: two per 64-ray half of A,
//     each with half the triangles; the warpgroups and the chunk width MXU_N
//     were chosen by bench_leaf's mxu_ab A/B), each issuing wgmma.mma_async (A
//     from registers, B from shared memory).  B is the K-major [4*K2][16]
//     table, split into hi / lo parts when it is staged once, in wgmma's
//     canonical no-swizzle layout (8-column core matrices of 16-byte K chunks,
//     stage_b).  The product is repeated every iteration, as the TPU kernel
//     repeats it.  Per chunk of MXU_N triangles one m64 x 4 MXU_N product
//     covers the four quantities (det, t*det, u*det, v*det) of those
//     triangles: the columns of B are permuted at staging (staged_column) so
//     that each 8-column group of the accumulator holds one quantity of 8
//     triangles and the next three the others, so one thread holds all four of
//     each (ray, triangle) pair and post-processes it (t = tdet / det, the
//     barycentric gates, t >= 1e-4, t < best).  One wide product per K step in
//     place of one narrow one per quantity took mxu_hi from 11.1 to 7.6 us an
//     iteration (PERF.md, section 6).  Each row's minimum is reduced over
//     the four lanes of its quad and, at the end of an iteration, over the
//     two warpgroups of its rays.  While one warpgroup post-processes, the
//     others' products run on the tensor cores (with a second accumulator
//     set per warpgroup, so that its own next products run during its
//     post-processing, ptxas serialized the wgmmas against the
//     post-processing all the same: remark C7514).
//
// Built with --fmad=false (the scalar modes equal the plain version bit for
// bit).  The host build (accel/cubuild.py::host_library) compiles the
// scalar modes' arithmetic as plain C++ through `leaf_host`, W lanes per
// ray run by group_walk.cuh's launch_groups as W threads; the tensor-core
// and cp.async code is CUDA only.

#include "trace_common.cuh"
#include "group_walk.cuh"
#ifdef __CUDACC__
#include <cuda_bf16.h>
#endif

namespace {

#ifndef LEAF_LANES
#define LEAF_LANES 8     // lanes per ray of the scalar modes: 1, 2, 4 or 8
#endif

constexpr int LEAF_RAYS = 128;
constexpr int WHILE_G = 16;
enum {
  M_VPU = 0,
  M_MXU_HI = 1,
  M_MXU_3X = 2,
  M_MXU_1X = 3,
  M_VPU_REC = 4,
  M_VPU_COND = 5,
  M_VPU_DMA = 6,
  M_VPU_WHILE = 7,
};

// Ray i of the [8, 128] ray table (rows ox oy oz dx dy dz t_max).
__device__ __forceinline__ Ray leaf_ray(const float* rays, int i) {
  Ray r;
  r.ox = rays[i];
  r.oy = rays[LEAF_RAYS + i];
  r.oz = rays[2 * LEAF_RAYS + i];
  r.dx = rays[3 * LEAF_RAYS + i];
  r.dy = rays[4 * LEAF_RAYS + i];
  r.dz = rays[5 * LEAF_RAYS + i];
  r.ix = r.iy = r.iz = 0.0f;   // the leaf test needs no reciprocals
  return r;
}

// The group's nearest accepted hit t of ray r over the k rows (three float4
// each, in shared memory or, in the host build, anywhere), gated t < bound;
// BIG_F32 when nothing is hit.
template <int W>
__device__ __forceinline__ float vpu_test(const Group<W>& g,
                                          const float4* rows, int k,
                                          const Ray& r, float bound) {
  Best b{BIG_F32, NO_SLOT, BIG_F32, NO_SLOT};
  int n_mask = 0;
  test_leaf<0, false, false, false>(rows, nullptr, 0, k, 0, 0, r, 0.0f,
                                    bound, b, n_mask, g.lane, W);
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1)
    b.t = fminf(b.t, g.xor_lane(b.t, off));
  return b.t;
}

// The recording update of vpu_rec / vpu_cond / vpu_dma / vpu_while: the
// group's nearest hit and its row (the least row among equal t, as the
// one-thread test and the plain version's first minimum break ties).
template <int W>
__device__ __forceinline__ void record(const Group<W>& g, const float4* rows,
                                       int k, const Ray& r, int blk0,
                                       float& best, int& best_blk) {
  Best b{BIG_F32, NO_SLOT, BIG_F32, NO_SLOT};
  int n_mask = 0;
  test_leaf<0, false, false, false>(rows, nullptr, 0, k, 0, 0, r, 0.0f,
                                    best + 1e-7f, b, n_mask, g.lane, W);
  group_best<0, false, W>(g, b);
  if (b.t < best) {
    best = b.t;
    best_blk = blk0 + b.slot;
  }
}

#ifdef __CUDACC__

// ---- cp.async ---------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Wait until at most `pending` cp.async groups are in flight (0..15).
__device__ __forceinline__ void cp_wait_pending(int pending) {
  switch (pending) {
#define LEAF_WAIT(N) \
  case N:            \
    cp_wait<N>();    \
    break;
    LEAF_WAIT(0) LEAF_WAIT(1) LEAF_WAIT(2) LEAF_WAIT(3) LEAF_WAIT(4)
    LEAF_WAIT(5) LEAF_WAIT(6) LEAF_WAIT(7) LEAF_WAIT(8) LEAF_WAIT(9)
    LEAF_WAIT(10) LEAF_WAIT(11) LEAF_WAIT(12) LEAF_WAIT(13) LEAF_WAIT(14)
#undef LEAF_WAIT
    default:
      cp_wait<15>();
  }
}

// The block's threads copy rows [k2 * 3 float4] of block `blk` into dst.
__device__ __forceinline__ void stage_block(float4* dst, const float4* src,
                                            int blk, int k2) {
  const float4* s = src + 3 * (size_t)blk * k2;
  for (int c = threadIdx.x; c < 3 * k2; c += blockDim.x)
    cp_async16(dst + c, s + c);
}

// ---- the scalar modes: W lanes per ray --------------------------------

template <int MODE, int W>
__global__ void __launch_bounds__(LEAF_RAYS * W)
leaf_scalar_kernel(const float4* __restrict__ tri_rows,
                   const float4* __restrict__ hbm_rows,
                   const float* __restrict__ rays, int k2, int n_blk,
                   int n_iter, int gate0, float* __restrict__ out) {
  extern __shared__ float4 smem[];
  const Group<W> g;
  const int ray = threadIdx.x / W;
  const Ray r = leaf_ray(rays, ray);
  float best = rays[6 * LEAF_RAYS + ray];
  int best_blk = 0;
  if (MODE == M_VPU || MODE == M_VPU_REC || MODE == M_VPU_COND) {
    for (int c = threadIdx.x; c < 3 * k2; c += blockDim.x)
      smem[c] = tri_rows[c];
    __syncthreads();
    for (int it = 0; it < n_iter; ++it) {
      if (MODE == M_VPU)
        best = fminf(best, vpu_test(g, smem, k2, r, best) + 1e-7f);
      else if (MODE == M_VPU_REC || it >= gate0)
        record(g, smem, k2, r, it, best, best_blk);
    }
  } else if (MODE == M_VPU_DMA) {
    float4* buf[2] = {smem, smem + 3 * k2};
    if (n_iter > 0) stage_block(buf[0], hbm_rows, 0, k2);
    cp_commit();
    for (int it = 0; it < n_iter; ++it) {
      if (it + 1 < n_iter)
        stage_block(buf[(it + 1) & 1], hbm_rows, (it + 1) % n_blk, k2);
      cp_commit();
      cp_wait<1>();      // this iteration's block has landed
      __syncthreads();
      if (it >= gate0) record(g, buf[it & 1], k2, r, it, best, best_blk);
      __syncthreads();   // before the next stage overwrites the buffer
    }
  } else {   // M_VPU_WHILE
    for (int v = 0; v < n_iter / WHILE_G; ++v) {
      float entry[WHILE_G];
      for (int c = 0; c < WHILE_G; ++c) {
        entry[c] = (float)c * 0.1f;
        stage_block(smem + 3 * (size_t)c * k2, hbm_rows,
                    (v * WHILE_G + c) % n_blk, k2);
        cp_commit();
      }
      unsigned mask = (1u << WHILE_G) - 1u;
      while (mask) {
        int bestc = 0;
        float beste = BIG_F32;
        for (int c = 0; c < WHILE_G; ++c)
          if (((mask >> c) & 1u) && entry[c] < beste) {
            bestc = c;
            beste = entry[c];
          }
        cp_wait_pending(WHILE_G - 1 - bestc);   // groups land in order
        __syncthreads();
        if (beste < BIG_F32)
          record(g, smem + 3 * (size_t)bestc * k2, k2, r, bestc, best,
                 best_blk);
        mask &= ~(1u << bestc);
      }
      __syncthreads();   // before the next visit overwrites the children
    }
  }
  if (g.lane == 0) out[ray] = best;
}

// ---- the tensor-core modes: wgmma from MXU_WGS warpgroups -------------

#ifndef LEAF_MXU_WGS
#define LEAF_MXU_WGS 4   // warpgroups of the tensor-core modes: 2 or 4
#endif
#ifndef LEAF_MXU_N
#define LEAF_MXU_N 16    // triangles per chunk (the wgmma n / 4): 16 or 32
#endif
constexpr int MXU_WGS = LEAF_MXU_WGS;
constexpr int MXU_THREADS = 128 * MXU_WGS;
constexpr int MXU_N = LEAF_MXU_N;
constexpr int MXU_ACC = 2 * MXU_N;        // accumulator floats per chunk
constexpr int MXU_SPLIT = MXU_WGS / 2;    // warpgroups per 64 rays
// K2 in multiples of this (the chunks split evenly over the warpgroups)
constexpr int MXU_K2 = MXU_SPLIT * MXU_N;

__device__ __forceinline__ unsigned tf32_of(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float bf16_rt(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Element k of ray r's row of A: d, o, o x d, 1, then zeros.
__device__ __forceinline__ float a_elem(const Ray& r, int k) {
  switch (k) {
    case 0: return r.dx;
    case 1: return r.dy;
    case 2: return r.dz;
    case 3: return r.ox;
    case 4: return r.oy;
    case 5: return r.oz;
    case 6: return r.oy * r.dz - r.oz * r.dy;
    case 7: return r.oz * r.dx - r.ox * r.dz;
    case 8: return r.ox * r.dy - r.oy * r.dx;
    case 9: return 1.0f;
    default: return 0.0f;
  }
}

// Bytes of one 8-column group of staged B: 16 K values of 8 columns.
template <int MODE>
__host__ __device__ constexpr unsigned group_bytes() {
  return MODE == M_MXU_HI ? 8 * 16 * 4 : 8 * 16 * 2;
}

// The staged column of B's column n = q * k2 + m (quantity q of triangle
// m): the columns of a chunk of MXU_N triangles follow each other, and in
// it the four quantities of 8 triangles fill 4 consecutive 8-column groups
// (group 4 (j / 8) + q holds quantity q of triangles 8 (j / 8) ..., j the
// triangle's index in its chunk).  A thread's accumulator of one m64 x
// (4 MXU_N) product then holds det, t*det, u*det and v*det of the same
// (ray, triangle) pairs.
__host__ __device__ constexpr int staged_column(int n, int k2) {
  return 4 * MXU_N * (n % k2 / MXU_N) + 32 * (n % k2 % MXU_N / 8) +
         8 * (n / k2) + n % k2 % 8;
}

// Stage trib [16, 4 k2] (row k, column n) into shared memory as the hi / lo
// parts of B in wgmma's canonical K-major no-swizzle layout: staged
// column s = staged_column(n), K chunk c (16 bytes: 4 tf32 or 8 bf16) at
// byte
//   (s / 8) * group_bytes + c * 128 + (s % 8) * 16,
// i.e. 8 consecutive columns of one K chunk form a 128-byte core matrix,
// the K chunks of an 8-column group follow each other (LBO = 128 B) and
// the groups follow each other (SBO = group_bytes).  Every thread of the
// block takes part.
template <int MODE>
__device__ __forceinline__ void stage_b(const float* __restrict__ trib,
                                        int k2, char* bh, char* bl) {
  constexpr int EPC = MODE == M_MXU_HI ? 4 : 8;   // elements per chunk
  constexpr int ES = 16 / EPC;                    // element bytes
  const int N = 4 * k2;
  for (int i = threadIdx.x; i < 16 * N; i += blockDim.x) {
    const int k = i / N, n = i - k * N;   // coalesced reads of trib
    const float x = trib[i];
    const int sc = staged_column(n, k2);
    const unsigned off = (sc >> 3) * group_bytes<MODE>() + (k / EPC) * 128 +
                         (sc & 7) * 16 + (k % EPC) * ES;
    if (MODE == M_MXU_HI) {
      const unsigned h = tf32_of(x);
      *(unsigned*)(bh + off) = h;
      *(unsigned*)(bl + off) = tf32_of(x - __uint_as_float(h));
    } else {
      const __nv_bfloat16 h = __float2bfloat16_rn(x);
      *(__nv_bfloat16*)(bh + off) = h;
      if (MODE == M_MXU_3X)
        *(__nv_bfloat16*)(bl + off) = __float2bfloat16_rn(
            x - __bfloat162float(h));
    }
  }
}

// The wgmma descriptor of a K-major no-swizzle operand at `p` (bits 0-13
// the address >> 4, 16-29 the leading byte offset (between K chunks) >> 4,
// 32-45 the stride byte offset (between 8-row groups) >> 4; base offset
// and layout type 0).
__device__ __forceinline__ uint64_t smem_desc(const void* p, unsigned lbo,
                                              unsigned sbo) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads of the accumulators above the wgmma
// wait.
__device__ __forceinline__ void acc_fence(float (&d)[MXU_ACC]) {
#pragma unroll
  for (int x = 0; x < MXU_ACC; ++x) asm volatile("" : "+f"(d[x])::"memory");
}

// The accumulator operands of one m64 x (4 MXU_N) product.
#if LEAF_MXU_N == 32
#define LEAF_N "128"
#define LEAF_D                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68"
#define LEAF_P "%69"
#define LEAF_DOUT(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), \
      "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), \
      "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
      "+f"(d[62]), "+f"(d[63])
#elif LEAF_MXU_N == 16
#define LEAF_N "64"
#define LEAF_D                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}, {%32, %33, %34, %35}, %36"
#define LEAF_P "%37"
#define LEAF_DOUT(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
      "+f"(d[30]), "+f"(d[31])
#else
#error "LEAF_MXU_N must be 16 or 32"
#endif

// d (+)= A [64 x 8] (tf32 fragments in registers) x B [8 x 4 MXU_N]
// (desc).
__device__ __forceinline__ void wgmma_tf32(float* d, const unsigned* a,
                                           uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, " LEAF_P ", 0;\n"
      "wgmma.mma_async.sync.aligned.m64n" LEAF_N "k8.f32.tf32.tf32 " LEAF_D
      ", p, 1, 1;\n}\n"
      : LEAF_DOUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// d (+)= A [64 x 16] (bf16 fragments in registers) x B [16 x 4 MXU_N]
// (desc).
__device__ __forceinline__ void wgmma_bf16(float* d, const unsigned* a,
                                           uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, " LEAF_P ", 0;\n"
      "wgmma.mma_async.sync.aligned.m64n" LEAF_N "k16.f32.bf16.bf16 " LEAF_D
      ", p, 1, 1, 0;\n}\n"
      : LEAF_DOUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// Issue the product of chunk `ch` (triangles MXU_N ch ..., staged columns
// 4 MXU_N ch ...) into d, in the mode's precision and term order (3xTF32
// per K step: lo*hi, hi*lo, hi*hi; bf16x3: al*bh, ah*bl, ah*bh).  dh / dl:
// the descriptors of B's hi / lo parts at column 0.
template <int MODE>
__device__ __forceinline__ void issue_chunk(float (&d)[MXU_ACC],
                                            const unsigned (&ah)[8],
                                            const unsigned (&al)[8],
                                            uint64_t dh, uint64_t dl,
                                            int ch) {
  constexpr unsigned GB = group_bytes<MODE>();
  const uint64_t col = (4 * MXU_N * ch >> 3) * (GB >> 4);
  wg_fence();
  if (MODE == M_MXU_HI) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {   // K chunks 2 ks, 2 ks + 1
      const uint64_t o = col + ks * (256 >> 4);
      wgmma_tf32(d, al + 4 * ks, dh + o, ks > 0);
      wgmma_tf32(d, ah + 4 * ks, dl + o, 1);
      wgmma_tf32(d, ah + 4 * ks, dh + o, 1);
    }
  } else if (MODE == M_MXU_3X) {
    wgmma_bf16(d, al, dh + col, 0);
    wgmma_bf16(d, ah, dl + col, 1);
    wgmma_bf16(d, ah, dh + col, 1);
  } else {
    wgmma_bf16(d, ah, dh + col, 0);
  }
  wg_commit();
}

// Post-process one chunk's accumulators: d[16 b + 4 q + e] is quantity q
// of row g + 8 (e / 2) of the warp's 16 and one triangle of the chunk's
// 8-triangle block b (staged_column); the nearest accepted t of each of
// the thread's two rows goes into tmin.
__device__ __forceinline__ void post_chunk(const float (&d)[MXU_ACC],
                                           const float (&best)[2],
                                           float (&tmin)[2]) {
#pragma unroll
  for (int i = 0; i < MXU_ACC / 4; ++i) {
    const int x = 16 * (i >> 2) + (i & 3), h = (i >> 1) & 1;
    const float det = d[x];
    const bool near0 = fabsf(det) < 1e-9f;
    const float inv_det = 1.0f / (near0 ? 1.0f : det);
    const float tt = d[x + 4] * inv_det;
    const float u = d[x + 8] * inv_det;
    const float v = d[x + 12] * inv_det;
    const bool ok = !near0 && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                    u + v <= 1.0f && tt >= 1e-4f && tt < best[h];
    if (ok) tmin[h] = fminf(tmin[h], tt);
  }
}

// The end of iteration `it`: each row's minimum over its quad (and, with
// four warpgroups, over the two that split its triangles, exchanged
// through xch by iteration parity and a named barrier of the pair), then
// best = min(best, tmin + 1e-7).
__device__ __forceinline__ void end_iteration(float (&best)[2],
                                              float (&tmin)[2], int it,
                                              int row0, float (*xch)[128]) {
  float x[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    x[h] = tmin[h];
    x[h] = fminf(x[h], __shfl_xor_sync(0xffffffffu, x[h], 1));
    x[h] = fminf(x[h], __shfl_xor_sync(0xffffffffu, x[h], 2));
    tmin[h] = BIG_F32;
  }
  if (MXU_SPLIT == 2) {
    const int half = threadIdx.x >> 8, par = it & 1;
    if ((threadIdx.x & 3) == 0) {
      xch[2 * par + half][row0] = x[0];
      xch[2 * par + half][row0 + 8] = x[1];
    }
    // the two warpgroups of rays row0 / 64 (1 + that: 0 is __syncthreads)
    asm volatile("bar.sync %0, 256;\n" ::"r"(1 + (row0 >> 6)) : "memory");
    x[0] = fminf(x[0], xch[2 * par + 1 - half][row0]);
    x[1] = fminf(x[1], xch[2 * par + 1 - half][row0 + 8]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) best[h] = fminf(best[h], x[h] + 1e-7f);
}

// Warpgroup w takes rays 64 (w % 2) ... and, with four warpgroups,
// triangle half w / 2; k2 a multiple of MXU_K2.
template <int MODE>
__global__ void __launch_bounds__(MXU_THREADS, 1)
leaf_mxu_kernel(const float* __restrict__ trib,
                const float* __restrict__ rays, int k2, int n_iter,
                float* __restrict__ out) {
  extern __shared__ __align__(128) char smem_b[];
  __shared__ float xch[4][128];   // [parity * 2 + half][ray]
  char* bh = smem_b;
  char* bl = smem_b + (4 * k2 / 8) * group_bytes<MODE>();
  stage_b<MODE>(trib, k2, bh, bl);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // warp w of warpgroup wg holds rays 64 (wg % 2) + 16 (w % 4) ... + 15
  const int row0 = 64 * ((threadIdx.x >> 7) & 1) +
                   16 * ((threadIdx.x >> 5) & 3) + g;   // rows row0, +8
  // A's fragments of rows row0 / row0 + 8 (the layout of the m16n8k8 tf32
  // / m16n8k16 bf16 A operand, per warp of the warpgroup), in registers
  const Ray ra[2] = {leaf_ray(rays, row0), leaf_ray(rays, row0 + 8)};
  unsigned ah[8], al[8];
  if (MODE == M_MXU_HI) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {   // (g, t) (g+8, t) (g, t+4) (g+8, t+4)
        const float v = a_elem(ra[e & 1], 8 * ks + t + 4 * (e >> 1));
        ah[4 * ks + e] = tf32_of(v);
        al[4 * ks + e] = tf32_of(v - __uint_as_float(ah[4 * ks + e]));
      }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {   // pairs (g, 2t) (g+8, 2t) (g, 2t+8) ..
      const int k = 2 * t + 8 * (e >> 1);
      const float x0 = a_elem(ra[e & 1], k), x1 = a_elem(ra[e & 1], k + 1);
      ah[e] = bf16x2(x0, x1);
      al[e] = bf16x2(x0 - bf16_rt(x0), x1 - bf16_rt(x1));
      ah[e + 4] = al[e + 4] = 0u;
    }
  }
  float best[2] = {rays[6 * LEAF_RAYS + row0], rays[6 * LEAF_RAYS + row0 + 8]};
  float tmin[2] = {BIG_F32, BIG_F32};
  const uint64_t dh = smem_desc(bh, 128, group_bytes<MODE>());
  const uint64_t dl = smem_desc(bl, 128, group_bytes<MODE>());
  // this warpgroup's chunks of an iteration: ch0 .. ch0 + chunks - 1
  const int chunks = k2 / (MXU_N * MXU_SPLIT);
  const int ch0 = chunks * (threadIdx.x >> 8);
  float d[MXU_ACC] = {};
  for (int it = 0; it < n_iter; ++it) {
    for (int c = 0; c < chunks; ++c) {
      issue_chunk<MODE>(d, ah, al, dh, dl, ch0 + c);
      wg_wait<0>();
      acc_fence(d);
      post_chunk(d, best, tmin);
    }
    end_iteration(best, tmin, it, row0, xch);
  }
  if (t == 0 && threadIdx.x < 256) {
    out[row0] = best[0];
    out[row0 + 8] = best[1];
  }
}

// Dynamic shared memory of a mode, in bytes.
size_t leaf_smem(int mode, int k2) {
  const size_t rows = (size_t)k2 * 48, b = (size_t)4 * k2 * 16;
  switch (mode) {
    case M_MXU_HI:
      return 2 * b * 4;
    case M_MXU_3X:
      return 2 * b * 2;
    case M_MXU_1X:
      return b * 2;
    case M_VPU_DMA:
      return 2 * rows;
    case M_VPU_WHILE:
      return WHILE_G * rows;
    default:
      return rows;
  }
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

#define LEAF_SCALAR_MODES(X) X(0) X(4) X(5) X(6) X(7)
#define LEAF_MXU_MODES(X) X(1) X(2) X(3)

// One block.  tri_rows [K2, 12], hbm_rows [n_blk * K2, 12], trib [16, 4*K2],
// rays [8, 128], out [128]; K2 a multiple of 8 (of MXU_K2 in the
// tensor-core modes).  The scalar modes run 128 x LEAF_LANES threads, the
// tensor-core modes MXU_WGS warpgroups.
extern "C" int leaf_launch(int mode, const float* tri_rows, const float* trib,
                           const float* rays, const float* hbm_rows, int k2,
                           int n_blk, int n_iter, int gate0, float* out,
                           void* stream) {
  const bool mxu = mode >= M_MXU_HI && mode <= M_MXU_1X;
  if (mode < 0 || mode > 7 || k2 < 8 || k2 % 8 || n_blk < 1 || n_iter < 0 ||
      (mxu && k2 % MXU_K2))
    return (int)cudaErrorInvalidValue;
  const size_t smem = leaf_smem(mode, k2);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int rc = 0;
  switch (mode) {
#define LEAF_MXU_CASE(M)                                                   \
  case M:                                                                  \
    rc = (int)cudaFuncSetAttribute(                                        \
        leaf_mxu_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,   \
        (int)smem);                                                        \
    if (rc) return rc;                                                     \
    leaf_mxu_kernel<M><<<1, MXU_THREADS, smem, st>>>(trib, rays, k2,       \
                                                     n_iter, out);         \
    break;
    LEAF_MXU_MODES(LEAF_MXU_CASE)
#undef LEAF_MXU_CASE
#define LEAF_SCALAR_CASE(M)                                                \
  case M:                                                                  \
    rc = (int)cudaFuncSetAttribute(                                        \
        leaf_scalar_kernel<M, LEAF_LANES>,                                 \
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);           \
    if (rc) return rc;                                                     \
    leaf_scalar_kernel<M, LEAF_LANES><<<1, LEAF_RAYS * LEAF_LANES, smem,   \
                                        st>>>(                             \
        (const float4*)tri_rows, (const float4*)hbm_rows, rays, k2, n_blk, \
        n_iter, gate0, out);                                               \
    break;
    LEAF_SCALAR_MODES(LEAF_SCALAR_CASE)
#undef LEAF_SCALAR_CASE
  }
  return (int)cudaGetLastError();
}

#else  // the host build: the scalar modes' arithmetic, W lanes per ray

namespace {

// Ray blockIdx.x of the scalar mode MODE, as one lane of its group (the
// device kernel's loops with the rows read in place of the staged ones).
template <int MODE, int W>
void leaf_host_ray(const float4* tri, const float4* hbm, const float* rays,
                   int k2, int n_blk, int n_iter, float* out) {
  const Group<W> g;
  const int i = blockIdx.x;
  const Ray r = leaf_ray(rays, i);
  float best = rays[6 * LEAF_RAYS + i];
  int best_blk = 0;
  if (MODE == M_VPU) {
    for (int it = 0; it < n_iter; ++it)
      best = fminf(best, vpu_test(g, tri, k2, r, best) + 1e-7f);
  } else if (MODE == M_VPU_REC || MODE == M_VPU_COND) {
    for (int it = 0; it < n_iter; ++it)
      record(g, tri, k2, r, it, best, best_blk);
  } else if (MODE == M_VPU_DMA) {
    for (int it = 0; it < n_iter; ++it)
      record(g, hbm + 3 * (size_t)(it % n_blk) * k2, k2, r, it, best,
             best_blk);
  } else {
    for (int v = 0; v < n_iter / WHILE_G; ++v)
      for (int c = 0; c < WHILE_G; ++c)
        record(g, hbm + 3 * (size_t)((v * WHILE_G + c) % n_blk) * k2, k2, r,
               c, best, best_blk);
  }
  if (g.lane == 0) out[i] = best;
}

}  // namespace

extern "C" int leaf_host(int mode, const float* tri_rows, const float* rays,
                         const float* hbm_rows, int k2, int n_blk, int n_iter,
                         float* out) {
  const float4* tri = (const float4*)tri_rows;
  const float4* hbm = (const float4*)hbm_rows;
  switch (mode) {
#define LEAF_HOST_MODE(M)                                                  \
  case M:                                                                  \
    return launch_groups<LEAF_LANES>(leaf_host_ray<M, LEAF_LANES>,         \
                                     LEAF_RAYS, 0, nullptr, tri, hbm, rays, \
                                     k2, n_blk, n_iter, out);
    LEAF_HOST_MODE(M_VPU) LEAF_HOST_MODE(M_VPU_REC)
    LEAF_HOST_MODE(M_VPU_COND) LEAF_HOST_MODE(M_VPU_DMA)
    LEAF_HOST_MODE(M_VPU_WHILE)
#undef LEAF_HOST_MODE
  }
  return 1;   // the tensor-core modes
}

#endif  // __CUDACC__
