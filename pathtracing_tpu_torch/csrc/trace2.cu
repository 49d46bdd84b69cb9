// Two-level closest-hit / any-hit ray-triangle traversal for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel2` of pathtracing_tpu/accel/pallas_trace2.py
// (called through `pallas_tri_intersect2`) over static world triangles, in
// four of its modes: closest hit, any-hit, and the alpha micro-mask modes
// amask=1 and amask=2 (with `alpha_cell_bits` of accel/_kernel_common.py as
// the __device__ function alpha_cell below).  It computes the same function:
// per ray the hit with the least t in [SHADOW_EPS, t_max) over the SAH block
// tables built by accel/trace2.py::build_tri_blocks2, or (any-hit) whether
// one exists.  Exact ties in t go to the least table slot, which makes the
// result independent of visit order and equal to the plain PyTorch version.
//
// Alpha micro-mask modes (template argument AMASK; mode 0 compiles to the
// code it had without them).  Each Moller-Trumbore hit loads its slot's 7
// mask words (two 16-byte loads, only on a hit) and looks up the tri-state
// cell (opaque / mixed / transparent) at the hit's barycentrics.
//   AMASK=1: a hit on a transparent cell is skipped; the rest is mode 0.
//   AMASK=2: the shadow walk.  The TPU kernel collapses a ray on any opaque-
//     cell hit below its CURRENT best mixed t, so its per-lane `solid`
//     depends on which block it visited first.  This kernel's contract does
//     not: it tracks the nearest opaque-cell hit t_opq and the nearest
//     mixed-cell hit (t_mix, slot; ties to the least slot), culls boxes
//     against min(t_mix, t_opq), and reports
//         t_opq < t_mix   -> solid: slot -2, no candidate;
//         else a mixed hit -> that hit;   else -> a miss.
//     Transparent hits are skipped.  Against the TPU kernel this gives: the
//     same miss lanes; every solid lane here is solid there; every solid
//     lane there is solid or a candidate here; and the restart chain built
//     on either (scene/intersect.py::_occluded) decides every lane alike.
//
// Design: one thread per ray.
//   * L1 phase: the thread slab-tests every L1 superblock box (warps read the
//     same box at the same time, so the table streams through L1 cache as
//     broadcasts) and keeps the L1_BUF nearest entries above a cursor in a
//     small sorted buffer.  It visits them nearest first; when the buffer ran
//     full it rescans from the last visited entry with the tightened best t.
//     So L1 boxes are visited in exact front-to-back order and the walk stops
//     at the first entry beyond the best hit.
//   * child phase: per visited L1 the G child boxes are slab-tested against
//     the current best t and the entered children drained nearest first.
//   * leaf phase: Moller-Trumbore over the K2 triangles of an entered child,
//     three 16-byte loads per triangle, with the arithmetic of
//     _kernel_common.moller_trumbore.  Any-hit returns on the first hit.
//   * box tests are conservative: the exit distance is widened by a few ulps
//     so rounding in the slab test cannot drop a hit that lies on a box face.
//
// Bound on the H100: the work is data dependent.  Per ray it is ~20 flops per
// L1 box per table pass, ~20 per child box of a visited L1, and ~40 per
// triangle of an entered child; the bytes that must move are the rays, the
// results, the L1 table and the child boxes and triangle rows the walk
// touches (counted with the `touched` flags), plus 32 bytes of mask words
// per hit in the alpha modes.  On the 10.5M-triangle tables with bounce
// rays the two sides are close and the bytes win (0.0992 ms of bytes
// against 0.0705 ms of operations per 65,280-ray dispatch, PERF.md); which
// side binds a dispatch is worked out from its own counters.  The measured
// time sits far above either because lanes of a warp diverge (different
// rays walk different blocks) and each triangle load is a dependent,
// scattered cache access.  Warp-cooperative leaves, shared-memory staging
// of the L1 table and ray sorting into coherent warps are the levers for a
// later revision.
//
// Built with --fmad=false: FMA contraction would change Moller-Trumbore's
// rounding and flip edge hits against the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float BIG_F32 = 3.0e38f;
constexpr float SHADOW_EPS = 1e-5f;
constexpr float WIDEN = 1.0000005f;   // conservative slab exit (+~4 ulp)
constexpr int L1_BUF = 16;
constexpr int NO_SLOT = 0x7fffffff;

__device__ __forceinline__ float inv_guard(float c) {
  return 1.0f / (fabsf(c) < 1e-32f ? (c < 0.0f ? -1e-32f : 1e-32f) : c);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// Slab entry distance of box (lo, hi) clipped to [SHADOW_EPS, bound];
// BIG_F32 when the ray does not enter it.
__device__ __forceinline__ float slab_entry(const float4* box, const Ray& r,
                                            float bound) {
  const float4 lo = __ldg(box);
  const float4 hi = __ldg(box + 1);
  float u0 = (lo.x - r.ox) * r.ix, u1 = (hi.x - r.ox) * r.ix;
  float tn = fminf(u0, u1), tf = fmaxf(u0, u1);
  u0 = (lo.y - r.oy) * r.iy;
  u1 = (hi.y - r.oy) * r.iy;
  tn = fmaxf(tn, fminf(u0, u1));
  tf = fminf(tf, fmaxf(u0, u1));
  u0 = (lo.z - r.oz) * r.iz;
  u1 = (hi.z - r.oz) * r.iz;
  tn = fmaxf(fmaxf(tn, fminf(u0, u1)), SHADOW_EPS);
  tf = fminf(fminf(tf, fmaxf(u0, u1)), bound);
  return tn <= tf * WIDEN ? tn : BIG_F32;
}

struct Best {
  float t;      // nearest accepted hit (AMASK=2: nearest mixed-cell hit)
  int slot;
  float t_opq;  // AMASK=2: nearest opaque-cell hit
};

// Tri-state alpha cell of slot `slot` at barycentrics (u, v): bit 0 set =
// definitely opaque, bit 1 set = mixed, neither = definitely transparent.
// Words 0..2 hold two bf16 coefficients each (low half b_i, high half c_i)
// of the affine map from (u, v) to the 8x8 cell grid; words 3/4 are the
// opaque bit plane, 5/6 the mixed one (cell = cv*8 + cu).
__device__ __forceinline__ int alpha_cell(const int4* __restrict__ mask,
                                          int slot, float u, float v) {
  const int4 m0 = __ldg(mask + 2 * (size_t)slot);
  const int4 m1 = __ldg(mask + 2 * (size_t)slot + 1);
  const float b0 = __int_as_float(m0.x << 16);
  const float b1 = __int_as_float(m0.y << 16);
  const float b2 = __int_as_float(m0.z << 16);
  const float c0 = __int_as_float(m0.x & 0xFFFF0000);
  const float c1 = __int_as_float(m0.y & 0xFFFF0000);
  const float c2 = __int_as_float(m0.z & 0xFFFF0000);
  const float gx = b0 + b1 * u + b2 * v;
  const float gy = c0 + c1 * u + c2 * v;
  const int cu = (int)fminf(fmaxf(floorf(gx), 0.0f), 7.0f);
  const int cv = (int)fminf(fmaxf(floorf(gy), 0.0f), 7.0f);
  const int cell = cv * 8 + cu;
  const int sh = cell & 31;
  const unsigned opq = (unsigned)(cell < 32 ? m0.w : m1.x);
  const unsigned mix = (unsigned)(cell < 32 ? m1.y : m1.z);
  return (int)((opq >> sh) & 1u) | (int)(((mix >> sh) & 1u) << 1);
}

// Moller-Trumbore over the k2 triangles of child block `blk`.  Returns true
// if any triangle was hit (any-hit callers stop there).  n_mask counts the
// mask lookups (AMASK != 0).
template <int AMASK>
__device__ __forceinline__ bool test_leaf(const float4* __restrict__ tri,
                                          const int4* __restrict__ mask,
                                          int blk, int k2, const Ray& r,
                                          float tmax0, Best& best,
                                          int& n_mask) {
  bool any = false;
  const int s0 = blk * k2;
  for (int k = 0; k < k2; ++k) {
    const float4* p = tri + 3 * (size_t)(s0 + k);
    const float4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
    const float e1x = a.w, e1y = b.x, e1z = b.y;
    const float e2x = b.z, e2y = b.w, e2z = c.x;
    const float hx = r.dy * e2z - r.dz * e2y;
    const float hy = r.dz * e2x - r.dx * e2z;
    const float hz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * hx + e1y * hy + e1z * hz;
    const bool near0 = fabsf(det) < 1e-9f;
    const float inv_det = 1.0f / (near0 ? 1.0f : det);
    const float sx = r.ox - a.x, sy = r.oy - a.y, sz = r.oz - a.z;
    const float u = (sx * hx + sy * hy + sz * hz) * inv_det;
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
    const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
    const bool ok = !near0 && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                    u + v <= 1.0f && t >= SHADOW_EPS && t < tmax0;
    if (ok) {
      const int slot = s0 + k;
      if (AMASK) {
        const int bits = alpha_cell(mask, slot, u, v);
        ++n_mask;
        if (AMASK == 1 && bits == 0) continue;       // transparent: a miss
        if (AMASK == 2) {
          if ((bits & 1) && t < best.t_opq) best.t_opq = t;
          if (!(bits & 2)) continue;                 // only mixed hits walk
        }
      }
      any = true;
      if (t < best.t || (t == best.t && slot < best.slot)) {
        best.t = t;
        best.slot = slot;
      }
    }
  }
  return any;
}

// The bound that culls boxes: the best hit so far (AMASK=2: the nearer of
// the best mixed and the best opaque hit; beyond it nothing changes the
// result).
template <int AMASK>
__device__ __forceinline__ float cull_bound(const Best& b) {
  return AMASK == 2 ? fminf(b.t, b.t_opq) : b.t;
}

template <int AMASK>
__global__ void __launch_bounds__(128)
trace2_kernel(const float* __restrict__ orig, const float* __restrict__ dirs,
              const float* __restrict__ tmax, int n,
              const float4* __restrict__ l1box, int m1,
              const int* __restrict__ l1_base,
              const float4* __restrict__ l2box,
              const float4* __restrict__ tri,
              const int4* __restrict__ tri_mask, int k2, int g, int any_hit,
              float* __restrict__ out_t, int* __restrict__ out_slot,
              int* __restrict__ counters,
              unsigned char* __restrict__ touched) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r;
  r.ox = orig[3 * i];
  r.oy = orig[3 * i + 1];
  r.oz = orig[3 * i + 2];
  r.dx = dirs[3 * i];
  r.dy = dirs[3 * i + 1];
  r.dz = dirs[3 * i + 2];
  r.ix = inv_guard(r.dx);
  r.iy = inv_guard(r.dy);
  r.iz = inv_guard(r.dz);
  const float tmax0 = tmax[i];
  Best best{tmax0, NO_SLOT, tmax0};
  int n_pass = 0, n_l1 = 0, n_leaf = 0, n_mask = 0;

  if (tmax0 > 0.0f) {
    float cur_e = -1.0f;   // (entry, index) cursor: everything at or below
    int cur_i = -1;        // it has been visited already
    bool done = false;   // no L1 entry left that could beat best.t
    bool stop = false;   // leave the buffer early (front reached / any-hit)
    while (!done) {
      float be[L1_BUF];
      int bi[L1_BUF];
      int cnt = 0;
      ++n_pass;
      for (int b = 0; b < m1; ++b) {
        const float e = slab_entry(l1box + 2 * b, r, cull_bound<AMASK>(best));
        if (e >= BIG_F32) continue;
        if (e < cur_e || (e == cur_e && b <= cur_i)) continue;
        if (cnt == L1_BUF && (e > be[L1_BUF - 1] ||
                              (e == be[L1_BUF - 1] && b > bi[L1_BUF - 1])))
          continue;
        int j = cnt < L1_BUF ? cnt : L1_BUF - 1;
        while (j > 0 && (be[j - 1] > e || (be[j - 1] == e && bi[j - 1] > b))) {
          be[j] = be[j - 1];
          bi[j] = bi[j - 1];
          --j;
        }
        be[j] = e;
        bi[j] = b;
        if (cnt < L1_BUF) ++cnt;
      }
      done = cnt < L1_BUF;
      for (int k = 0; k < cnt && !stop; ++k) {
        if (be[k] > cull_bound<AMASK>(best) * WIDEN) {   // front-to-back:
          // nothing later helps
          stop = true;
          break;
        }
        ++n_l1;
        if (touched) touched[bi[k]] = 1;
        const int base = l1_base[bi[k]];
        float ce[64];
        unsigned long long mask = 0ull;
        for (int c = 0; c < g; ++c) {
          const float e = slab_entry(l2box + 2 * (base + c), r,
                                     cull_bound<AMASK>(best));
          ce[c] = e;
          if (e < BIG_F32) mask |= 1ull << c;
        }
        while (mask) {
          float em = BIG_F32;
          int cm = -1;
          for (unsigned long long m = mask; m; m &= m - 1) {
            const int c = __ffsll((long long)m) - 1;
            if (ce[c] < em) {
              em = ce[c];
              cm = c;
            }
          }
          mask &= ~(1ull << cm);
          if (em > cull_bound<AMASK>(best) * WIDEN) break;
          ++n_leaf;
          if (touched) touched[m1 + base + cm] = 1;
          if (test_leaf<AMASK>(tri, tri_mask, base + cm, k2, r, tmax0, best,
                               n_mask) && any_hit) {
            stop = true;
            break;
          }
        }
      }
      done = done || stop;
      if (!done) {
        cur_e = be[cnt - 1];
        cur_i = bi[cnt - 1];
      }
    }
  }
  const bool solid = AMASK == 2 && best.t_opq < best.t;
  const bool hit = best.slot != NO_SLOT && !solid;
  out_t[i] = hit ? best.t : BIG_F32;
  out_slot[i] = solid ? -2 : (hit ? best.slot : -1);
  if (counters) {
    counters[4 * i] = n_pass;
    counters[4 * i + 1] = n_l1;
    counters[4 * i + 2] = n_leaf;
    counters[4 * i + 3] = n_mask;
  }
}

}  // namespace

extern "C" int trace2_launch(const float* orig, const float* dirs,
                             const float* tmax, int n, const float* l1box,
                             int m1, const int* l1_base, const float* l2box,
                             const float* tri, const int* mask, int k2, int g,
                             int any_hit, int amask, float* out_t,
                             int* out_slot, int* counters,
                             unsigned char* touched, void* stream) {
  if (n <= 0) return 0;
  if (amask < 0 || amask > 2 || (amask && (any_hit || mask == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int block = 128;
  const int grid = (n + block - 1) / block;
#define TRACE2_LAUNCH(AMASK)                                              \
  trace2_kernel<AMASK><<<grid, block, 0, (cudaStream_t)stream>>>(         \
      orig, dirs, tmax, n, (const float4*)l1box, m1, l1_base,             \
      (const float4*)l2box, (const float4*)tri, (const int4*)mask, k2, g, \
      any_hit, out_t, out_slot, counters, touched)
  if (amask == 0) TRACE2_LAUNCH(0);
  else if (amask == 1) TRACE2_LAUNCH(1);
  else TRACE2_LAUNCH(2);
#undef TRACE2_LAUNCH
  return (int)cudaGetLastError();
}
