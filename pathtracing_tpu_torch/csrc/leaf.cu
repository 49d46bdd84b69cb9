// The leaf-test micro-benchmark (K4) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of tools/bench_mxu_leaf.py (called
// through `run_mode`): one block of 128 rays, one ray per thread, loops
// n_iter leaf tests of K2 triangles over tables resident in shared memory
// (no traversal), in eight modes that each compute what the TPU mode does:
//   vpu       scalar Moller-Trumbore (trace_common.cuh::test_leaf),
//             loop-carried best = min(best, tbest + 1e-7) (the test is
//             gated t < best);
//   mxu_hi    the determinant form: q = A [128,16] x B [16, 4*K2] gives
//             det, t*det, u*det, v*det per (ray, triangle) on the tensor
//             cores (mma.sync m16n8k8 TF32) in 3xTF32: a = a_hi + a_lo,
//             b = b_hi + b_lo, q = a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, the
//             f32-faithful split (Hopper has no f32 tensor-core mode: this
//             is the analog of precision=HIGHEST);
//   mxu_3x    the manual bf16x3 split (hi = bf16(x), lo = bf16(x - hi);
//             ah*bh + ah*bl + al*bh) with bf16 mma.sync m16n8k16;
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
// The tensor-core modes hold A's fragments in registers for the whole
// loop and read B's from shared memory; the post-processing (t = tdet /
// det, the barycentric gates, t >= 1e-4, t < best) runs on the
// accumulator fragments, and each row's minimum is reduced over the four
// lanes of its quad.
//
// Bound on the H100: the work is compute only (the tables are read once):
// per iteration 128 x K2 triangle tests, ~45 fp32 operations each in the
// scalar modes (67 TFLOP/s), or a 2 x 128 x 16 x 4K2 product per tensor
// pass (3 passes TF32 at 495 TFLOP/s, 3 or 1 bf16 at 989) plus ~14 fp32
// operations per pair of post-processing.  One block runs on one of the
// 132 SMs, as the TPU tool runs on one core, so the kernel cannot come
// within 132x of that whole-card bound: the question it answers is the
// per-SM cost of a child test in each form.
//
// Built with --fmad=false (the scalar modes equal the plain version bit for
// bit).  The host build (accel/cubuild.py::host_library) compiles the
// scalar modes' arithmetic as plain C++ through `leaf_host`; the tensor-core
// and cp.async code is CUDA only.

#include "trace_common.cuh"
#ifdef __CUDACC__
#include <cuda_bf16.h>
#endif

namespace {

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

// One leaf test: the nearest accepted hit of ray r over the k rows (three
// float4 each, in shared memory or, in the host build, anywhere), gated
// t < bound; kbest its row (the first minimum: test_leaf breaks ties to
// the least slot).  BIG_F32 when nothing is hit.
__device__ __forceinline__ float vpu_test(const float4* rows, int k,
                                          const Ray& r, float bound,
                                          int& kbest) {
  Best b{BIG_F32, NO_SLOT, BIG_F32, NO_SLOT};
  int n_mask = 0;
  test_leaf<0, false, false, false>(rows, nullptr, 0, k, 0, 0, r, 0.0f,
                                    bound, b, n_mask);
  kbest = b.slot == NO_SLOT ? 0 : b.slot;
  return b.t;
}

// The recording update of vpu_rec / vpu_cond / vpu_dma / vpu_while.
__device__ __forceinline__ void record(const float4* rows, int k,
                                       const Ray& r, int blk0, float& best,
                                       int& best_blk) {
  int kb;
  const float tb = vpu_test(rows, k, r, best + 1e-7f, kb);
  if (tb < best) {
    best = tb;
    best_blk = blk0 + kb;
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
  for (int c = threadIdx.x; c < 3 * k2; c += LEAF_RAYS)
    cp_async16(dst + c, s + c);
}

// ---- the scalar modes -------------------------------------------------

template <int MODE>
__device__ void scalar_modes(const float4* tri_rows, const float4* hbm_rows,
                             const float* rays, int k2, int n_blk,
                             int n_iter, int gate0, float* out,
                             float4* smem) {
  const int tid = threadIdx.x;
  const Ray r = leaf_ray(rays, tid);
  float best = rays[6 * LEAF_RAYS + tid];
  int best_blk = 0;
  if (MODE == M_VPU || MODE == M_VPU_REC || MODE == M_VPU_COND) {
    for (int c = tid; c < 3 * k2; c += LEAF_RAYS) smem[c] = tri_rows[c];
    __syncthreads();
    for (int it = 0; it < n_iter; ++it) {
      if (MODE == M_VPU) {
        int kb;
        const float tb = vpu_test(smem, k2, r, best, kb);
        best = fminf(best, tb + 1e-7f);
      } else if (MODE == M_VPU_REC || it >= gate0) {
        record(smem, k2, r, it, best, best_blk);
      }
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
      if (it >= gate0) record(buf[it & 1], k2, r, it, best, best_blk);
      __syncthreads();   // before the next stage overwrites the buffer
    }
  } else {   // M_VPU_WHILE
    for (int v = 0; v < n_iter / WHILE_G; ++v) {
      float entry[WHILE_G];
      for (int g = 0; g < WHILE_G; ++g) {
        entry[g] = (float)g * 0.1f;
        stage_block(smem + 3 * (size_t)g * k2, hbm_rows,
                    (v * WHILE_G + g) % n_blk, k2);
        cp_commit();
      }
      unsigned mask = (1u << WHILE_G) - 1u;
      while (mask) {
        int bestg = 0;
        float beste = BIG_F32;
        for (int g = 0; g < WHILE_G; ++g)
          if (((mask >> g) & 1u) && entry[g] < beste) {
            bestg = g;
            beste = entry[g];
          }
        cp_wait_pending(WHILE_G - 1 - bestg);   // groups land in order
        __syncthreads();
        if (beste < BIG_F32)
          record(smem + 3 * (size_t)bestg * k2, k2, r, bestg, best,
                 best_blk);
        mask &= ~(1u << bestg);
      }
      __syncthreads();   // before the next visit overwrites the children
    }
  }
  out[tid] = best;
}

// ---- the tensor-core modes --------------------------------------------

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

__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// q = A x B for one 16-row tile of A and one 8-column tile of B (column
// n0 .. n0+7 of the 4*K2 columns), in the mode's precision.  Fragment
// layouts are those of the PTX ISA for m16n8k8 (tf32) / m16n8k16 (bf16):
// g = lane / 4 names the rows (g, g+8) and the B column, t = lane % 4 the
// k positions.  Bh / Bl: B transposed to [4*K2][16] (k contiguous), hi and
// lo parts (bf16 in 16-bit halves, tf32 in 32-bit words).
template <int MODE>
__device__ __forceinline__ void tile_product(float* d, const unsigned* ah,
                                             const unsigned* al,
                                             const void* Bh, const void* Bl,
                                             int n0, int g, int t) {
  d[0] = d[1] = d[2] = d[3] = 0.0f;
  const int n = n0 + g;
  if (MODE == M_MXU_HI) {
    const unsigned* bh = (const unsigned*)Bh + 16 * n;
    const unsigned* bl = (const unsigned*)Bl + 16 * n;
    for (int ks = 0; ks < 2; ++ks) {   // small terms first
      mma_tf32(d, al + 4 * ks, bh[8 * ks + t], bh[8 * ks + t + 4]);
      mma_tf32(d, ah + 4 * ks, bl[8 * ks + t], bl[8 * ks + t + 4]);
      mma_tf32(d, ah + 4 * ks, bh[8 * ks + t], bh[8 * ks + t + 4]);
    }
  } else {
    const unsigned* bh = (const unsigned*)Bh + 8 * n;   // 16 bf16 = 8 words
    if (MODE == M_MXU_3X) {
      const unsigned* bl = (const unsigned*)Bl + 8 * n;
      mma_bf16(d, al, bh[t], bh[t + 4]);
      mma_bf16(d, ah, bl[t], bl[t + 4]);
    }
    mma_bf16(d, ah, bh[t], bh[t + 4]);
  }
}

template <int MODE>
__device__ void mxu_modes(const float* trib, const float* rays, int k2,
                          int n_iter, float* out, float4* smem) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int N = 4 * k2;
  // A [128][16] in shared memory, one row per ray
  float* A = (float*)smem;
  {
    const Ray r = leaf_ray(rays, tid);
    float* a = A + 16 * tid;
    a[0] = r.dx;
    a[1] = r.dy;
    a[2] = r.dz;
    a[3] = r.ox;
    a[4] = r.oy;
    a[5] = r.oz;
    a[6] = r.oy * r.dz - r.oz * r.dy;
    a[7] = r.oz * r.dx - r.ox * r.dz;
    a[8] = r.ox * r.dy - r.oy * r.dx;
    a[9] = 1.0f;
    for (int k = 10; k < 16; ++k) a[k] = 0.0f;
  }
  // B transposed, split into hi / lo parts
  void* Bh = (char*)smem + LEAF_RAYS * 16 * sizeof(float);
  const size_t part = (size_t)N * 16 * (MODE == M_MXU_HI ? 4 : 2);
  void* Bl = (char*)Bh + part;
  for (int i = tid; i < N * 16; i += LEAF_RAYS) {
    const int n = i >> 4, k = i & 15;
    const float x = trib[(size_t)k * N + n];
    if (MODE == M_MXU_HI) {
      const unsigned h = tf32_of(x);
      ((unsigned*)Bh)[i] = h;
      ((unsigned*)Bl)[i] = tf32_of(x - __uint_as_float(h));
    } else {
      const __nv_bfloat16 h = __float2bfloat16_rn(x);
      ((__nv_bfloat16*)Bh)[i] = h;
      if (MODE == M_MXU_3X)
        ((__nv_bfloat16*)Bl)[i] = __float2bfloat16_rn(x -
                                                      __bfloat162float(h));
    }
  }
  __syncthreads();
  // A fragments of this warp's two 16-row tiles, kept in registers
  unsigned ah[2][8], al[2][8];
  float best[2][2];
  for (int mt = 0; mt < 2; ++mt) {
    const int r0 = 32 * warp + 16 * mt + g;
    const float* x0 = A + 16 * r0;
    const float* x1 = A + 16 * (r0 + 8);
    best[mt][0] = rays[6 * LEAF_RAYS + r0];
    best[mt][1] = rays[6 * LEAF_RAYS + r0 + 8];
    if (MODE == M_MXU_HI) {
      for (int ks = 0; ks < 2; ++ks) {
        const float v[4] = {x0[8 * ks + t], x1[8 * ks + t],
                            x0[8 * ks + t + 4], x1[8 * ks + t + 4]};
        for (int e = 0; e < 4; ++e) {
          ah[mt][4 * ks + e] = tf32_of(v[e]);
          al[mt][4 * ks + e] = tf32_of(v[e] - __uint_as_float(
                                                  ah[mt][4 * ks + e]));
        }
      }
    } else {
      const int c[4][2] = {{0, 2 * t}, {1, 2 * t}, {0, 2 * t + 8},
                           {1, 2 * t + 8}};
      for (int e = 0; e < 4; ++e) {
        const float* x = c[e][0] ? x1 : x0;
        const float p = x[c[e][1]], q = x[c[e][1] + 1];
        ah[mt][e] = bf16x2(p, q);
        al[mt][e] = bf16x2(p - bf16_rt(p), q - bf16_rt(q));
      }
    }
  }
  const int tiles = k2 / 8;
  for (int it = 0; it < n_iter; ++it) {
    float tmin[2][2] = {{BIG_F32, BIG_F32}, {BIG_F32, BIG_F32}};
    for (int j = 0; j < tiles; ++j) {
      for (int mt = 0; mt < 2; ++mt) {
        float q[4][4];
        for (int s = 0; s < 4; ++s)
          tile_product<MODE>(q[s], ah[mt], al[mt], Bh, Bl,
                             8 * (s * tiles + j), g, t);
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float det = q[0][e];
          const bool near0 = fabsf(det) < 1e-9f;
          const float inv_det = 1.0f / (near0 ? 1.0f : det);
          const float tt = q[1][e] * inv_det;
          const float u = q[2][e] * inv_det;
          const float v = q[3][e] * inv_det;
          const bool ok = !near0 && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                          u + v <= 1.0f && tt >= 1e-4f && tt < best[mt][h];
          if (ok) tmin[mt][h] = fminf(tmin[mt][h], tt);
        }
      }
    }
    for (int mt = 0; mt < 2; ++mt)
      for (int h = 0; h < 2; ++h) {
        float x = tmin[mt][h];
        x = fminf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fminf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        best[mt][h] = fminf(best[mt][h], x + 1e-7f);
      }
  }
  if (t == 0)
    for (int mt = 0; mt < 2; ++mt) {
      const int r0 = 32 * warp + 16 * mt + g;
      out[r0] = best[mt][0];
      out[r0 + 8] = best[mt][1];
    }
}

template <int MODE>
__global__ void __launch_bounds__(LEAF_RAYS)
leaf_kernel(const float* __restrict__ tri_rows, const float* __restrict__ trib,
            const float* __restrict__ rays,
            const float* __restrict__ hbm_rows, int k2, int n_blk,
            int n_iter, int gate0, float* __restrict__ out) {
  extern __shared__ float4 smem[];
  if (MODE == M_MXU_HI || MODE == M_MXU_3X || MODE == M_MXU_1X)
    mxu_modes<MODE>(trib, rays, k2, n_iter, out, smem);
  else
    scalar_modes<MODE>((const float4*)tri_rows, (const float4*)hbm_rows,
                       rays, k2, n_blk, n_iter, gate0, out, smem);
}

// Dynamic shared memory of a mode, in bytes.
size_t leaf_smem(int mode, int k2) {
  const size_t rows = (size_t)k2 * 48, a = LEAF_RAYS * 16 * 4;
  switch (mode) {
    case M_MXU_HI:
      return a + 2 * (size_t)4 * k2 * 16 * 4;
    case M_MXU_3X:
      return a + 2 * (size_t)4 * k2 * 16 * 2;
    case M_MXU_1X:
      return a + (size_t)4 * k2 * 16 * 2;
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

#define LEAF_MODES(X) X(0) X(1) X(2) X(3) X(4) X(5) X(6) X(7)

// One block of 128 threads.  tri_rows [K2, 12], hbm_rows [n_blk * K2, 12],
// trib [16, 4*K2], rays [8, 128], out [128]; K2 a multiple of 8.
extern "C" int leaf_launch(int mode, const float* tri_rows, const float* trib,
                           const float* rays, const float* hbm_rows, int k2,
                           int n_blk, int n_iter, int gate0, float* out,
                           void* stream) {
  if (mode < 0 || mode > 7 || k2 < 8 || k2 % 8 || n_blk < 1 || n_iter < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = leaf_smem(mode, k2);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  switch (mode) {
#define LEAF_CASE(M)                                                       \
  case M: {                                                                \
    const int rc = (int)cudaFuncSetAttribute(                              \
        leaf_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,       \
        (int)smem);                                                        \
    if (rc) return rc;                                                     \
    leaf_kernel<M><<<1, LEAF_RAYS, smem, (cudaStream_t)stream>>>(          \
        tri_rows, trib, rays, hbm_rows, k2, n_blk, n_iter, gate0, out);    \
    break;                                                                 \
  }
    LEAF_MODES(LEAF_CASE)
#undef LEAF_CASE
  }
  return (int)cudaGetLastError();
}

#else  // the host build: the scalar modes' arithmetic, one ray at a time

extern "C" int leaf_host(int mode, const float* tri_rows, const float* rays,
                         const float* hbm_rows, int k2, int n_blk, int n_iter,
                         float* out) {
  if (mode != M_VPU && mode < M_VPU_REC) return 1;   // tensor-core modes
  const float4* tri = (const float4*)tri_rows;
  const float4* hbm = (const float4*)hbm_rows;
  for (int i = 0; i < LEAF_RAYS; ++i) {
    const Ray r = leaf_ray(rays, i);
    float best = rays[6 * LEAF_RAYS + i];
    int best_blk = 0;
    if (mode == M_VPU) {
      for (int it = 0; it < n_iter; ++it) {
        int kb;
        best = fminf(best, vpu_test(tri, k2, r, best, kb) + 1e-7f);
      }
    } else if (mode == M_VPU_REC || mode == M_VPU_COND) {
      for (int it = 0; it < n_iter; ++it) record(tri, k2, r, it, best,
                                                 best_blk);
    } else if (mode == M_VPU_DMA) {
      for (int it = 0; it < n_iter; ++it)
        record(hbm + 3 * (size_t)(it % n_blk) * k2, k2, r, it, best,
               best_blk);
    } else {
      for (int v = 0; v < n_iter / WHILE_G; ++v)
        for (int g = 0; g < WHILE_G; ++g)
          record(hbm + 3 * (size_t)((v * WHILE_G + g) % n_blk) * k2, k2, r,
                 g, best, best_blk);
    }
    out[i] = best;
  }
  return 0;
}

#endif  // __CUDACC__
