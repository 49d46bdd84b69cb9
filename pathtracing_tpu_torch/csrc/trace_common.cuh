// Device code shared by the two traversal kernels (csrc/trace2.cu, the
// two-level walk, and csrc/trace1.cu, the single-level walk); the leaf
// micro-benchmark (csrc/leaf.cu) runs the same leaf test.
//
// Replaces the in-kernel helpers of pathtracing_tpu/accel/_kernel_common.py
// (make_recull -> the cull bound, instance_transform -> instance_ray,
// moller_trumbore -> test_leaf, alpha_cell_bits -> alpha_cell; entry_phase
// and make_select became group_walk.cuh's front).  Keeping them here keeps
// the two kernels in lock-step: the slab epsilon, the tie-break and the
// leaf arithmetic are one definition.
//
// One definition of a tie: the hit with the least t wins; exact ties in t go
// to the least (block, slot) pair, where for plain tables `block` is unused
// and `slot` is the table slot, and for instanced tables `block` is the
// EXPANDED block (one per instance and physical block) and `slot` the offset
// inside it.  The plain PyTorch versions order ties the same way, so kernel
// and plain version agree exactly whatever the visit order.
//
// One definition of the arithmetic: everything is built with --fmad=false and
// every sum is written in the order the plain versions evaluate it (the
// instance transform is ((m0*ox + m1*oy) + m2*oz) + m3).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float BIG_F32 = 3.0e38f;
constexpr float SHADOW_EPS = 1e-5f;
constexpr float WIDEN = 1.0000005f;   // conservative slab exit (+~4 ulp)
constexpr int NO_SLOT = 0x7fffffff;

__device__ __forceinline__ float inv_guard(float c) {
  return 1.0f / (fabsf(c) < 1e-32f ? (c < 0.0f ? -1e-32f : 1e-32f) : c);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// Slab entry distance of box (lo, hi) clipped to [SHADOW_EPS, bound];
// BIG_F32 when the ray does not enter it.
__device__ __forceinline__ float slab_entry(const float4 lo, const float4 hi,
                                            const Ray& r, float bound) {
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

// The same for a box row of a table in global memory (read-only cache).
__device__ __forceinline__ float slab_entry(const float4* box, const Ray& r,
                                            float bound) {
  return slab_entry(__ldg(box), __ldg(box + 1), r, bound);
}

struct Best {
  float t;      // nearest accepted hit (AMASK=2: nearest mixed-cell hit)
  int slot;     // its slot (instanced: offset inside the expanded block)
  float t_opq;  // AMASK=2: nearest opaque-cell hit
  int blk;      // instanced tables only: its expanded block
};

// The bound that culls boxes: the best hit so far (AMASK=2: the nearer of
// the best mixed and the best opaque hit; beyond it nothing changes the
// result).
template <int AMASK>
__device__ __forceinline__ float cull_bound(const Best& b) {
  return AMASK == 2 ? fminf(b.t, b.t_opq) : b.t;
}

// Object-space ray of instance row `m` (12 floats, the row-major inverse
// affine [3,4]): origin affine, direction linear and left UNNORMALIZED so t
// stays the world parameter; `vel` (3 floats, object-space velocity of a
// moving instance, or nullptr) shifts the origin by -vel * time.  The
// reciprocals are recomputed for the new direction.
__device__ __forceinline__ Ray instance_ray(const float* __restrict__ m,
                                            const float* __restrict__ vel,
                                            float time, const Ray& w) {
  const float4 r0 = __ldg((const float4*)m);
  const float4 r1 = __ldg((const float4*)m + 1);
  const float4 r2 = __ldg((const float4*)m + 2);
  Ray l;
  l.ox = r0.x * w.ox + r0.y * w.oy + r0.z * w.oz + r0.w;
  l.oy = r1.x * w.ox + r1.y * w.oy + r1.z * w.oz + r1.w;
  l.oz = r2.x * w.ox + r2.y * w.oy + r2.z * w.oz + r2.w;
  l.dx = r0.x * w.dx + r0.y * w.dy + r0.z * w.dz;
  l.dy = r1.x * w.dx + r1.y * w.dy + r1.z * w.dz;
  l.dz = r2.x * w.dx + r2.y * w.dy + r2.z * w.dz;
  if (vel) {
    l.ox = l.ox - __ldg(vel) * time;
    l.oy = l.oy - __ldg(vel + 1) * time;
    l.oz = l.oz - __ldg(vel + 2) * time;
  }
  l.ix = inv_guard(l.dx);
  l.iy = inv_guard(l.dy);
  l.iz = inv_guard(l.dz);
  return l;
}

// Tri-state alpha cell of slot `slot` at barycentrics (u, v): bit 0 set =
// definitely opaque, bit 1 set = mixed, neither = definitely transparent.
// Words 0..2 hold two bf16 coefficients each (low half b_i, high half c_i)
// of the affine map from (u, v) to the 8x8 cell grid; words 3/4 are the
// opaque bit plane, 5/6 the mixed one (cell = cv*8 + cu).  The words are
// object-space data: an instanced model carries them once.
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

// Moller-Trumbore over the k triangles of physical block `blk` (rows
// blk*k .. blk*k+k-1 of the [slots, 12] table: v0 xyz, e1 xyz, e2 xyz, then
// the velocity xyz under MOTION).  A hit is recorded as (eblk, key0 + i):
// plain tables pass key0 = blk*k (the table slot) and ignore eblk; instanced
// tables (INST) pass the expanded block and the offset of this block inside
// it.  Returns true if any triangle was hit (any-hit callers stop there).
// n_mask counts the mask lookups (AMASK != 0).  LDG: the rows are read
// through the read-only cache (global memory); false for rows staged in
// shared memory (the leaf micro-benchmark, leaf.cu).  i0 / di: test only
// triangles i0, i0 + di, ... (one lane of a group that shares the block;
// the defaults test them all).
template <int AMASK, bool INST, bool MOTION, bool LDG = true>
__device__ __forceinline__ bool test_leaf(const float4* __restrict__ tri,
                                          const int4* __restrict__ mask,
                                          int blk, int k, int eblk, int key0,
                                          const Ray& r, float time,
                                          float tmax0, Best& best,
                                          int& n_mask, int i0 = 0,
                                          int di = 1) {
  bool any = false;
  const int s0 = blk * k;
  for (int i = i0; i < k; i += di) {
    const float4* p = tri + 3 * (size_t)(s0 + i);
    const float4 a = LDG ? __ldg(p) : p[0];
    const float4 b = LDG ? __ldg(p + 1) : p[1];
    const float4 c = LDG ? __ldg(p + 2) : p[2];
    const float e1x = a.w, e1y = b.x, e1z = b.y;
    const float e2x = b.z, e2y = b.w, e2z = c.x;
    const float hx = r.dy * e2z - r.dz * e2y;
    const float hy = r.dz * e2x - r.dx * e2z;
    const float hz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * hx + e1y * hy + e1z * hz;
    const bool near0 = fabsf(det) < 1e-9f;
    const float inv_det = 1.0f / (near0 ? 1.0f : det);
    float sx = r.ox - a.x, sy = r.oy - a.y, sz = r.oz - a.z;
    if (MOTION) {   // a moving triangle at ray time == the static one hit
      sx = sx - c.y * time;   // from o - vel * time
      sy = sy - c.z * time;
      sz = sz - c.w * time;
    }
    const float u = (sx * hx + sy * hy + sz * hz) * inv_det;
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
    const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
    const bool ok = !near0 && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                    u + v <= 1.0f && t >= SHADOW_EPS && t < tmax0;
    if (ok) {
      if (AMASK) {
        const int bits = alpha_cell(mask, s0 + i, u, v);
        ++n_mask;
        if (AMASK == 1 && bits == 0) continue;       // transparent: a miss
        if (AMASK == 2) {
          if ((bits & 1) && t < best.t_opq) best.t_opq = t;
          if (!(bits & 2)) continue;                 // only mixed hits walk
        }
      }
      any = true;
      const int key = key0 + i;
      bool better = t < best.t;
      if (t == best.t) {
        better = INST ? (eblk < best.blk ||
                         (eblk == best.blk && key < best.slot))
                      : key < best.slot;
      }
      if (better) {
        best.t = t;
        best.slot = key;
        if (INST) best.blk = eblk;
      }
    }
  }
  return any;
}

}  // namespace
