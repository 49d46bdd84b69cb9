// Single-level closest-hit / any-hit ray-triangle traversal for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_kernel` of pathtracing_tpu/accel/pallas_trace.py
// (called through `pallas_tri_intersect`): the walk over ONE level of
// K-triangle SAH blocks that the builder gives triangle sets of 65,536 or
// fewer and small instanced scenes.  Modes: closest hit, any-hit, the alpha
// micro-mask modes amask=1 and amask=2, run-time instances, linear motion
// (not instances + motion and not masks + motion: the reference's tables
// carry neither).  It computes the same function as the two-level kernel
// (trace2.cu) over its own tables (accel/trace1.py: build_tri_blocks /
// build_tri_blocks_inst) and shares its device functions (trace_common.cuh):
// the same tie rule, the same order-independent amask=2 contract, the same
// arithmetic, so it equals its plain PyTorch version exactly.
//
// It is a kernel of its own and not the two-level kernel over a padded
// table: a 96-triangle model would pad to G x K2 slots per L1 there, here it
// is one block of K.
//
// Design: one thread per ray.
//   * block phase: the thread slab-tests every block box (for instanced
//     tables the EXPANDED list: one world box per instance and physical
//     block) and keeps the FRONT_BUF nearest above a cursor, sorted; it
//     visits them nearest first and rescans from the last visited entry with
//     the tightened best t when the buffer ran full.  The TPU kernel's entry
//     phase, argmin pop and periodic re-cull collapse into this: per ray the
//     cull against the best hit is exact at every visit, and the tile device
//     of collapsing best_t to 0 on an any-hit is a return.
//   * leaf phase: Moller-Trumbore over the K triangles of the visited block
//     (the physical block blk_src[b], with the ray taken to object space by
//     the instance's inverse affine, for instanced tables).
//
// Bound on the H100: per ray ~20 flops per block box per table pass and ~45
// per triangle of a visited block; the bytes that must move are the rays, the
// results, the block table and the triangle rows of the blocks some ray
// visited (plus 32 B of mask words per looked-up hit).  With M of a few
// hundred and K = 128 the operations bind; the measured time sits above the
// bound for the reasons given in trace2.cu (divergent lanes, dependent
// scattered loads).
//
// Built with --fmad=false, as trace2.cu is.

#include "trace_common.cuh"

namespace {

template <int AMASK, bool INST, bool MOTION>
__global__ void __launch_bounds__(128)
trace1_kernel(const float* __restrict__ orig, const float* __restrict__ dirs,
              const float* __restrict__ tmax, int n,
              const float4* __restrict__ blkbox, int m,
              const float4* __restrict__ tri,
              const int4* __restrict__ tri_mask, int k, int any_hit,
              const int* __restrict__ blk_src,
              const int* __restrict__ blk_inst,
              const float* __restrict__ inst_inv,
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
  int n_pass = 0, n_blk = 0, n_mask = 0;

  if (tmax0 > 0.0f) {
    float cur_e = -1.0f;   // (entry, index) cursor: everything at or below
    int cur_i = -1;        // it has been visited already
    bool done = false;
    while (!done) {
      float be[FRONT_BUF];
      int bi[FRONT_BUF];
      ++n_pass;
      const int cnt = front_fill(blkbox, m, r, cull_bound<AMASK>(best), cur_e,
                                 cur_i, be, bi);
      done = cnt < FRONT_BUF;
      for (int j = 0; j < cnt; ++j) {
        if (be[j] > cull_bound<AMASK>(best) * WIDEN) {   // front-to-back:
          done = true;                                   // nothing later helps
          break;
        }
        ++n_blk;
        const int b = bi[j];
        const int src = INST ? blk_src[b] : b;
        if (touched) touched[src] = 1;
        Ray rl = r;
        if (INST) {
          const int inst = blk_inst[b];
          if (inst >= 0)
            rl = instance_ray(inst_inv + 12 * (size_t)inst, nullptr, 0.0f, r);
        }
        if (test_leaf<AMASK, INST, MOTION>(tri, tri_mask, src, k, b,
                                           INST ? 0 : src * k, rl, time,
                                           tmax0, best, n_mask) && any_hit) {
          done = true;
          break;
        }
      }
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
    counters[4 * i + 1] = n_blk;
    counters[4 * i + 2] = n_blk;   // every visited block is a leaf block
    counters[4 * i + 3] = n_mask;
  }
}

}  // namespace

// mode: 0..2 = AMASK, 3 = instanced, 4 = motion.
#define TRACE1_MODES(X) \
  X(0, 0, false, false) X(1, 1, false, false) X(2, 2, false, false) \
  X(3, 0, true, false) X(4, 0, false, true)

extern "C" int trace1_launch(const float* orig, const float* dirs,
                             const float* tmax, int n, const float* blkbox,
                             int m, const float* tri, const int* mask, int k,
                             int any_hit, int amask, const int* blk_src,
                             const int* blk_inst, const float* inst_inv,
                             const float* times, float* out_t, int* out_slot,
                             int* out_blk, int* counters,
                             unsigned char* touched, void* stream) {
  if (n <= 0) return 0;
  const bool inst = blk_src != nullptr;
  const bool motion = times != nullptr;
  if (amask < 0 || amask > 2 ||
      (amask && (any_hit || mask == nullptr || motion || inst)) ||
      (inst && (motion || !blk_inst || !inst_inv || !out_blk)))
    return (int)cudaErrorInvalidValue;
  const int block = 128;
  const int grid = (n + block - 1) / block;
  switch (inst ? 3 : (motion ? 4 : amask)) {
#define TRACE1_CASE(MODE, AMASK, INST, MOTION)                               \
  case MODE:                                                                 \
    trace1_kernel<AMASK, INST, MOTION>                                       \
        <<<grid, block, 0, (cudaStream_t)stream>>>(                          \
            orig, dirs, tmax, n, (const float4*)blkbox, m,                   \
            (const float4*)tri, (const int4*)mask, k, any_hit, blk_src,      \
            blk_inst, inst_inv, times, out_t, out_slot, out_blk, counters,   \
            touched);                                                        \
    break;
    TRACE1_MODES(TRACE1_CASE)
#undef TRACE1_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
