// Two-level closest-hit / any-hit ray-triangle traversal for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel2` of pathtracing_tpu/accel/pallas_trace2.py
// (called through `pallas_tri_intersect2`): closest hit, any-hit, the alpha
// micro-mask modes amask=1 and amask=2, run-time instances and linear motion.
// The device functions it shares with the single-level kernel (trace1.cu)
// live in trace_common.cuh.  It computes the same function: per ray the hit
// with the least t in [SHADOW_EPS, t_max) over the SAH block tables built by
// accel/trace2.py (build_tri_blocks2 / build_tri_blocks2_inst), or (any-hit)
// whether one exists.  Exact ties in t go to the least table slot (instanced:
// the least expanded L1, then the least offset in it), which makes the result
// independent of visit order and equal to the plain PyTorch version.
//
// Instanced tables (template argument INST).  The L1 list is instance-
// EXPANDED: entry b carries a WORLD box, the physical L1 blk_src[b] whose
// children and triangles are stored once per model in object space, and the
// instance blk_inst[b] (-1: a world row, no transform).  The L1 phase orders
// and culls the expanded entries in world space; per visited entry the ray is
// taken to object space with the instance's inverse affine (direction left
// unnormalized, so child-box and triangle distances are still the world t
// and compare with hits of any other instance), and the physical L1's
// children are walked there.  A hit is reported as (expanded L1, offset in
// it): the wrapper recovers the instance from the first and the triangle
// from blk_src and the second.  The inverse transforms are read from global
// memory through the read-only cache.  Ids are plain int32: the reference's
// 2^24 limits guard its float32 transpose and have no counterpart here.
//
// Motion (template argument MOTION): each ray carries a time; a triangle row's
// floats 9..11 are its velocity and the leaf test shifts the origin by
// -vel * time; a moving instance shifts the object-space origin by its
// object-space velocity * time.  Boxes are built over the shutter interval.
// Mask words and velocities are separate tables here, but the builder keeps
// the reference's rule (no masks on a moving scene).
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
//     broadcasts) and keeps the FRONT_BUF nearest entries above a cursor in a
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

#include "trace_common.cuh"

namespace {

template <int AMASK, bool INST, bool MOTION>
__global__ void __launch_bounds__(128)
trace2_kernel(const float* __restrict__ orig, const float* __restrict__ dirs,
              const float* __restrict__ tmax, int n,
              const float4* __restrict__ l1box, int m1,
              const int* __restrict__ l1_base,
              const float4* __restrict__ l2box,
              const float4* __restrict__ tri,
              const int4* __restrict__ tri_mask, int k2, int g, int any_hit,
              const int* __restrict__ blk_src,
              const int* __restrict__ blk_inst,
              const float* __restrict__ inst_inv,
              const float* __restrict__ inst_velo,
              const float* __restrict__ times,
              float* __restrict__ out_t, int* __restrict__ out_slot,
              int* __restrict__ out_blk, int* __restrict__ counters,
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
  const float time = MOTION ? times[i] : 0.0f;
  Best best{tmax0, NO_SLOT, tmax0, NO_SLOT};
  int n_pass = 0, n_l1 = 0, n_leaf = 0, n_mask = 0;

  if (tmax0 > 0.0f) {
    float cur_e = -1.0f;   // (entry, index) cursor: everything at or below
    int cur_i = -1;        // it has been visited already
    bool done = false;   // no L1 entry left that could beat best.t
    bool stop = false;   // leave the buffer early (front reached / any-hit)
    while (!done) {
      float be[FRONT_BUF];
      int bi[FRONT_BUF];
      ++n_pass;
      const int cnt = front_fill(l1box, m1, r, cull_bound<AMASK>(best), cur_e,
                                 cur_i, be, bi);
      done = cnt < FRONT_BUF;
      for (int k = 0; k < cnt && !stop; ++k) {
        if (be[k] > cull_bound<AMASK>(best) * WIDEN) {   // front-to-back:
          // nothing later helps
          stop = true;
          break;
        }
        ++n_l1;
        if (touched) touched[bi[k]] = 1;
        const int base = l1_base[INST ? blk_src[bi[k]] : bi[k]];
        // the ray in the visited L1's source space
        Ray rl = r;
        if (INST) {
          const int inst = blk_inst[bi[k]];
          if (inst >= 0)
            rl = instance_ray(inst_inv + 12 * (size_t)inst,
                              MOTION ? inst_velo + 3 * (size_t)inst : nullptr,
                              time, r);
        }
        float ce[64];
        unsigned long long mask = 0ull;
        for (int c = 0; c < g; ++c) {
          const float e = slab_entry(l2box + 2 * (base + c), rl,
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
          if (test_leaf<AMASK, INST, MOTION>(
                  tri, tri_mask, base + cm, k2, bi[k],
                  INST ? cm * k2 : (base + cm) * k2, rl, time, tmax0, best,
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
  if (INST) out_blk[i] = hit ? best.blk : -1;
  if (counters) {
    counters[4 * i] = n_pass;
    counters[4 * i + 1] = n_l1;
    counters[4 * i + 2] = n_leaf;
    counters[4 * i + 3] = n_mask;
  }
}

}  // namespace

// mode = AMASK + 3 * INST + 6 * MOTION.  Masks and motion exclude each other.
#define TRACE2_MODES(X) \
  X(0, 0, false, false) X(1, 1, false, false) X(2, 2, false, false) \
  X(3, 0, true, false) X(4, 1, true, false) X(5, 2, true, false) \
  X(6, 0, false, true) X(9, 0, true, true)

extern "C" int trace2_launch(const float* orig, const float* dirs,
                             const float* tmax, int n, const float* l1box,
                             int m1, const int* l1_base, const float* l2box,
                             const float* tri, const int* mask, int k2, int g,
                             int any_hit, int amask, const int* blk_src,
                             const int* blk_inst, const float* inst_inv,
                             const float* inst_velo, const float* times,
                             float* out_t, int* out_slot, int* out_blk,
                             int* counters, unsigned char* touched,
                             void* stream) {
  if (n <= 0) return 0;
  const bool inst = blk_src != nullptr;
  const bool motion = times != nullptr;
  if (amask < 0 || amask > 2 ||
      (amask && (any_hit || mask == nullptr || motion)) ||
      (inst && (!blk_inst || !inst_inv || !out_blk || (motion && !inst_velo))))
    return (int)cudaErrorInvalidValue;
  const int block = 128;
  const int grid = (n + block - 1) / block;
  switch (amask + 3 * (int)inst + 6 * (int)motion) {
#define TRACE2_CASE(MODE, AMASK, INST, MOTION)                                \
  case MODE:                                                                  \
    trace2_kernel<AMASK, INST, MOTION>                                        \
        <<<grid, block, 0, (cudaStream_t)stream>>>(                           \
            orig, dirs, tmax, n, (const float4*)l1box, m1, l1_base,           \
            (const float4*)l2box, (const float4*)tri, (const int4*)mask, k2,  \
            g, any_hit, blk_src, blk_inst, inst_inv, inst_velo, times, out_t, \
            out_slot, out_blk, counters, touched);                            \
    break;
    TRACE2_MODES(TRACE2_CASE)
#undef TRACE2_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
