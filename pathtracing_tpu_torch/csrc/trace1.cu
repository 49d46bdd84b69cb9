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
// build_tri_blocks_inst) and shares its device functions (trace_common.cuh)
// and its group walk (group_walk.cuh): the same tie rule, the same
// order-independent amask=2 contract, the same arithmetic, so it equals its
// plain PyTorch version exactly.
//
// It is a kernel of its own and not the two-level kernel over a padded
// table: a 96-triangle model would pad to G x K2 slots per L1 there, here it
// is one block of K.
//
// Design: a group of W = TRACE1_LANES lanes per ray (group_walk.cuh has the
// primitives and the front).  A 128-thread block holds 128 / W rays.
//   * block phase: the top level is the block table itself (for instanced
//     tables the EXPANDED list: one world box per instance and physical
//     block).  A front over coarse unions of up to 8 blocks (the wrapper's
//     pk_cbox / pk_cmem / pk_cgrp: 8 consecutive blocks of world tables,
//     SAH neighbours among the expanded blocks of instanced ones; the union
//     boxes staged in shared memory with cp.async when they fit in
//     STAGE_MAX_BYTES).  Lane j slab-tests the unions j, j + W, ... and keeps
//     its own short sorted part of the front above a cursor in registers;
//     the group takes the least (entry, key) across lanes by a shuffle
//     reduction, a union that reaches the head is replaced by its entered
//     members, and a lane that runs dry below its horizon makes the group
//     rescan from the cursor with the tightened bound.  The blocks are so
//     visited in exactly the flat (entry, index) order of a one-thread walk
//     over every block box, and the walk stops at the first block beyond
//     the best hit; per pass it tests the unions plus the members of the
//     unions already expanded, not every block.  The TPU kernel's entry
//     phase, argmin pop and periodic re-cull collapse into this: per ray the
//     cull against the best hit is exact at every visit, and the tile device
//     of collapsing best_t to 0 on an any-hit is a group vote and a return.
//   * leaf phase: the visited block is the leaf (there is no child level).
//     Lane j runs Moller-Trumbore (_kernel_common.moller_trumbore's
//     arithmetic) on triangles j, j + W, ... of the block (the physical
//     block blk_src[b], with the ray taken to object space by the
//     instance's inverse affine, the same in every lane, for instanced
//     tables), so neighbouring lanes read neighbouring 48-byte rows; the
//     group reduces its best hit (t, then the least key; amask=2 the least
//     opaque t apart) and, for any-hit, ends on a ballot.
//   * every decision is taken on group-reduced values, so the group never
//     diverges; the front lives in registers (no run-time-indexed arrays).
//   * box tests are conservative: the exit distance is widened by a few ulps
//     so rounding in the slab test cannot drop a hit that lies on a box face.
//   * no tensor cores: the hit decision stays in the plain version's fp32
//     arithmetic, bit for bit.
//
// Bound on the H100: the work is data dependent.  Per ray it is ~20 flops per
// top-level slab test (unions and members, counted by the kernel) and ~45
// per triangle of a visited block; the bytes that must move are the rays,
// the results, the block table and its unions and the triangle rows of the
// blocks some ray visited (plus 32 B of mask words per looked-up hit).  With
// M of a few hundred and K = 128 the operations bind.  The time sits above
// the bound because each ray's walk is a chain of dependent loads (latency):
// W lanes per ray put W x more rays' chains in flight than one thread per
// ray at the same 128-thread blocks, and split each block's K triangle
// tests W ways.
//
// Built with --fmad=false, as trace2.cu is.

#include "trace_common.cuh"
#include "group_walk.cuh"

#ifndef TRACE1_LANES
#define TRACE1_LANES 16    // lanes per ray of the group walk
#endif

namespace {

// The group walk: one ray per W lanes.  The coarse table is staged in
// shared memory when `stage` (every thread of the block takes part before
// any group leaves).  16 lanes (8 triangles of a 128-triangle block per
// lane) and no minimum of blocks per SM: in an interleaved A/B on the
// H100 (tools/bench_trace1.py, PERF.md section 6) W = 16 took 6% less
// than W = 8 over path B's four modes weighted by their launches and
// 9-12% less on the instanced and moving soups; a minimum of 4 or 6
// blocks let ptxas take up to 78 registers and cost up to 8%; a minimum
// of 8 spilled in the moving instance.  ptxas keeps every instance in
// 61-66 registers with no stack frame and no spills: 7-8 blocks of 128
// per SM.
template <int AMASK, bool INST, bool MOTION, int W>
__global__ void __launch_bounds__(128)
trace1_kernel(const float* __restrict__ orig, const float* __restrict__ dirs,
              const float* __restrict__ tmax, int n,
              const float4* __restrict__ blkbox,
              const float4* __restrict__ coarse, int nc,
              const int4* __restrict__ members,
              const int* __restrict__ union_of, int stage,
              const float4* __restrict__ tri,
              const int4* __restrict__ tri_mask, int k, int any_hit,
              const int* __restrict__ blk_src,
              const int* __restrict__ blk_inst,
              const float* __restrict__ inst_inv,
              const float* __restrict__ times,
              float* __restrict__ out_t, int* __restrict__ out_slot,
              int* __restrict__ out_blk, int* __restrict__ counters,
              unsigned char* __restrict__ touched) {
  const Top top{blkbox, stage_rows(coarse, 2 * nc, stage != 0), nc, members,
                union_of};
  const Group<W> g;
  const int i = blockIdx.x * (blockDim.x / W) + threadIdx.x / W;
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
  int n_pass = 0, n_blk = 0, n_mask = 0, n_top = 0;

  if (tmax0 > 0.0f) {
    Front2<LaneFrontSize<W>::value> f;
    front_clear(f.lane);
    f.lane.he = -1.0f;            // nothing filled yet: everything beyond
    f.lane.ho = -1;
    f.ce = -1.0f;
    f.co = -1;
    float he;
    int ho;
    // front-to-back: stop at the first block beyond the best hit
    while (front_head(g, f, top, r, cull_bound<AMASK>(best), he, ho, n_pass,
                      n_top) &&
           he <= cull_bound<AMASK>(best) * WIDEN) {
      front_take(f, he, ho);
      ++n_blk;
      const int b = ho >> 1;
      const int src = INST ? __ldg(blk_src + b) : b;
      if (touched && g.lane == 0) touched[src] = 1;
      Ray rl = r;
      if (INST) {
        const int inst = __ldg(blk_inst + b);
        if (inst >= 0)
          rl = instance_ray(inst_inv + 12 * (size_t)inst, nullptr, 0.0f, r);
      }
      Best lb = best;
      const bool any = test_leaf<AMASK, INST, MOTION>(
          tri, tri_mask, src, k, b, INST ? 0 : src * k, rl, time, tmax0, lb,
          n_mask, g.lane, W);
      group_best<AMASK, INST, W>(g, lb);
      best = lb;
      if (any_hit && g.any(any)) break;
    }
  }
  n_mask = group_sum(g, n_mask);
  n_top = group_sum(g, n_top);
  if (g.lane != 0) return;
  const bool solid = AMASK == 2 && best.t_opq < best.t;
  const bool hit = best.slot != NO_SLOT && !solid;
  out_t[i] = hit ? best.t : BIG_F32;
  out_slot[i] = solid ? -2 : (hit ? best.slot : -1);
  if (INST) out_blk[i] = hit ? best.blk : -1;
  if (counters) {
    counters[5 * i] = n_pass;
    counters[5 * i + 1] = n_blk;
    counters[5 * i + 2] = n_blk;   // every visited block is a leaf block
    counters[5 * i + 3] = n_mask;
    counters[5 * i + 4] = n_top;
  }
}

}  // namespace

// mode: 0..2 = AMASK, 3 = instanced, 4 = motion.
#define TRACE1_MODES(X) \
  X(0, 0, false, false) X(1, 1, false, false) X(2, 2, false, false) \
  X(3, 0, true, false) X(4, 0, false, true)

// coarse / nc: the coarse unions ([nc, 8] f32: lo xyz, the bits of the
// least member, hi xyz, 0), members ([nc, COARSE_G] i32, ascending, -1
// padded), union_of ([m] i32); every block in exactly one union.
extern "C" int trace1_launch(const float* orig, const float* dirs,
                             const float* tmax, int n, const float* blkbox,
                             int m, const float* coarse, int nc,
                             const int* members, const int* union_of,
                             const float* tri, const int* mask, int k,
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
      (inst && (motion || !blk_inst || !inst_inv || !out_blk)) ||
      !coarse || !members || !union_of || nc < 1 || nc > m)
    return (int)cudaErrorInvalidValue;
  const int stage = nc * 32 <= STAGE_MAX_BYTES;
  const int smem = stage ? nc * 32 : 0;
  switch (inst ? 3 : (motion ? 4 : amask)) {
#define TRACE1_CASE(MODE, AMASK, INST, MOTION)                                \
  case MODE:                                                                  \
    return launch_groups<TRACE1_LANES>(                                       \
        trace1_kernel<AMASK, INST, MOTION, TRACE1_LANES>, n, smem, stream,    \
        orig, dirs, tmax, n, (const float4*)blkbox, (const float4*)coarse,    \
        nc, (const int4*)members, union_of, stage, (const float4*)tri,        \
        (const int4*)mask, k, any_hit, blk_src, blk_inst, inst_inv, times,    \
        out_t, out_slot, out_blk, counters, touched);
    TRACE1_MODES(TRACE1_CASE)
#undef TRACE1_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Blocks of 128 threads per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// of mode `mode`'s kernel with `smem` bytes of staged coarse table.
extern "C" int trace1_occupancy(int mode, int smem, int* blocks) {
#ifdef __CUDACC__
  switch (mode) {
#define TRACE1_OCC(MODE, AMASK, INST, MOTION)                                 \
  case MODE:                                                                  \
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(                \
        blocks, trace1_kernel<AMASK, INST, MOTION, TRACE1_LANES>, 128, smem);
    TRACE1_MODES(TRACE1_OCC)
#undef TRACE1_OCC
    default:
      return (int)cudaErrorInvalidValue;
  }
#else
  (void)mode, (void)smem, (void)blocks;
  return (int)cudaErrorInvalidValue;
#endif
}
