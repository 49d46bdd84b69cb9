// Two-level closest-hit / any-hit ray-triangle traversal for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel2` of pathtracing_tpu/accel/pallas_trace2.py
// (called through `pallas_tri_intersect2`): closest hit, any-hit, the alpha
// micro-mask modes amask=1 and amask=2, run-time instances, linear motion,
// and the pops / window schedules.  The TPU kernel's visit cap with its
// multipass resume state and its paired visits are not ported: neither
// changes a result and neither won on the card.
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
// Design: a group of W = TRACE2_LANES lanes per ray (8; group_walk.cuh has
// the primitives and the front).  A 128-thread block holds 128 / W rays.
//   * L1 phase: a front over coarse unions of up to 8 L1 entries (the
//     wrapper's pk_cbox / pk_cmem: consecutive entries of world tables,
//     SAH neighbours among instanced ones; the union boxes staged in shared
//     memory with cp.async when they fit in STAGE_MAX_BYTES).  Lane j slab-tests the unions j, j + W,
//     ... and keeps its own short sorted part of the front above a cursor
//     in registers; the group takes the least (entry, key) across lanes by
//     a shuffle reduction.  A union that reaches the head is replaced by its
//     entered members (by its owner lane); a lane that runs dry below its
//     horizon (the least key it dropped) makes the group rescan from the
//     cursor with the tightened bound.  The L1 entries are so visited in
//     exactly the flat (entry, index) order of the one-thread walk, and the
//     walk stops at the first entry beyond the best hit; per pass it tests
//     the unions plus the members of unions already expanded, not every L1.
//   * child phase: the G child boxes of a visited L1 are split over the
//     lanes (entries in registers) and drained nearest first by group
//     minimum, the bound read again for every child.
//   * leaf phase: lane j runs Moller-Trumbore (_kernel_common.moller_trumbore's
//     arithmetic) on triangles j, j + W, ... of the child, so neighbouring
//     lanes read neighbouring 48-byte rows; the group reduces its best hit
//     (t, then the least key) and, for any-hit, ends on a ballot.
//   * instancing: every lane takes the ray to the visited entry's object
//     space alike.
//   * box tests are conservative: the exit distance is widened by a few ulps
//     so rounding in the slab test cannot drop a hit that lies on a box face.
//   * no tensor cores: the hit decision stays in the plain version's fp32
//     arithmetic, bit for bit.
// The window walk (window 2 / 4, trace2_window_kernel) is the same group
// walk with a wider child phase: the group's front yields the `window`
// nearest L1 entries that can still beat the bound (the entries window 1
// would take next, in the same order), their window x G child entries are
// split over the lanes in registers (entry q = j * G + c on lane q mod W)
// and drained nearest first by group minimum on (entry, q), `pops`
// children per read of the bound.  Its width TRACE2_WINDOW_LANES (16) and
// its launch bounds TRACE2_WINDOW_BLOCKS (at least 6 blocks of 128 per SM:
// 80 registers, with small spills in the instanced modes) were chosen by
// the interleaved A/B of tools/bench_window.py on path C's alpha passes
// (PERF.md, section 6).
//
// Bound on the H100: the work is data dependent.  Per ray it is ~20 flops per
// top-level slab test (unions and members, counted by the kernel), ~20 per
// child box of a visited L1, and ~45 per triangle of an entered child; the
// bytes that must move are the rays, the results, the top-level tables and
// the child boxes and triangle rows the walk touches (counted with the
// `touched` flags), plus 32 bytes of mask words per hit in the alpha modes.
// On the 10.5M-triangle tables with bounce rays the bytes bind; which side
// binds a dispatch is worked out from its own counters.  The time sits
// above the bound because each ray's walk is a chain of dependent,
// scattered loads (latency); W lanes per ray put 8x more rays' chains in
// flight than one thread per ray at the same 128-thread blocks.
//
// Schedules (runtime arguments; none changes a result, only the order of
// the work, because ties go to the least slot whatever the visit order):
//   pops     children taken per drain step before the bound is read again
//            (the main path passes meta.block_pops = 4).  The group walk
//            reads the bound for every child whatever pops is (splitting
//            the lanes over `pops` children measured slower, PERF.md
//            section 6); the window walk takes pops;
//   window   2 or 4: the resident-window drain (pallas_trace2.py:918-1160):
//            take the `window` nearest L1 entries that can still beat the
//            bound, slab-test all their children (each in its own space),
//            and drain the union nearest first, `pops` children per read
//            of the bound; ties go to the L1 taken first (nearest entry,
//            then least index), then the least child.  The TPU's VMEM
//            double buffering has no counterpart: children are read
//            through the cache.
//
// Built with --fmad=false: FMA contraction would change Moller-Trumbore's
// rounding and flip edge hits against the plain version.

#include "trace_common.cuh"
#include "group_walk.cuh"

namespace {

// The tables of one launch.
struct Tabs {
  const float4* l1box;
  int m1;
  const int* l1_base;
  const float4* l2box;
  const float4* tri;
  const int4* tri_mask;
  int k2, g;
  const int* blk_src;
  const int* blk_inst;
  const float* inst_inv;
  const float* inst_velo;
  unsigned char* touched;
};

// The ray of L1 entry b in its source space (object space of b's instance).
template <bool INST, bool MOTION>
__device__ __forceinline__ Ray l1_ray(const Tabs& tb, int b, const Ray& r,
                                      float time) {
  if (INST) {
    const int inst = tb.blk_inst[b];
    if (inst >= 0)
      return instance_ray(tb.inst_inv + 12 * (size_t)inst,
                          MOTION ? tb.inst_velo + 3 * (size_t)inst : nullptr,
                          time, r);
  }
  return r;
}

// Visit L1 entry b with the group: the lanes slab-test its G children (lane
// j: children j, j + W, ...; entries in registers) and drain the entered
// ones nearest first by group minimum, one child per read of the bound.
// Every lane works on that child: lane j tests its triangles j, j + W, ...
// (neighbouring lanes read neighbouring 48-byte rows), then the group
// reduces its best hit.  True when an any-hit walk found an occluder.
template <int AMASK, bool INST, bool MOTION, int W>
__device__ __forceinline__ bool visit_l1_group(const Group<W>& g,
                                               const Tabs& tb, int b,
                                               const Ray& r, float time,
                                               float tmax0, int any_hit,
                                               Best& best, int& n_leaf,
                                               int& n_mask) {
  constexpr int CPL = (64 + W - 1) / W;   // children per lane, G <= 64
  if (tb.touched && g.lane == 0) tb.touched[b] = 1;
  const int base = tb.l1_base[INST ? tb.blk_src[b] : b];
  const Ray rl = l1_ray<INST, MOTION>(tb, b, r, time);
  float ce[CPL];   // this lane's children's entries, BIG_F32 once taken
  const float cb0 = cull_bound<AMASK>(best);
#pragma unroll
  for (int q = 0; q < CPL; ++q) {
    const int c = g.lane + q * W;
    ce[q] = c < tb.g ? slab_entry(tb.l2box + 2 * (base + c), rl, cb0)
                     : BIG_F32;
  }
  while (true) {
    float em = BIG_F32;
    int cm = INT_MAX;
#pragma unroll
    for (int q = 0; q < CPL; ++q)
      if (key_less(ce[q], g.lane + q * W, em, cm)) {
        em = ce[q];
        cm = g.lane + q * W;
      }
    group_min(g, em, cm);
    // drained, or nearest first: nothing later helps
    if (em >= BIG_F32 || em > cull_bound<AMASK>(best) * WIDEN) return false;
#pragma unroll
    for (int q = 0; q < CPL; ++q)
      if (cm == g.lane + q * W) ce[q] = BIG_F32;
    ++n_leaf;
    if (tb.touched && g.lane == 0) tb.touched[tb.m1 + base + cm] = 1;
    Best lb = best;
    const bool any = test_leaf<AMASK, INST, MOTION>(
        tb.tri, tb.tri_mask, base + cm, tb.k2, b,
        INST ? cm * tb.k2 : (base + cm) * tb.k2, rl, time, tmax0, lb, n_mask,
        g.lane, W);
    group_best<AMASK, INST, W>(g, lb);
    best = lb;
    if (any_hit && g.any(any)) return true;
  }
}

constexpr int WINDOW_MAX = 4;

// Element k of a WINDOW_MAX array held in registers (no runtime index, so
// the array stays out of local memory).
__device__ __forceinline__ int pick(const int (&a)[WINDOW_MAX], int k) {
  int v = a[0];
#pragma unroll
  for (int j = 1; j < WINDOW_MAX; ++j)
    if (k == j) v = a[j];
  return v;
}

// The resident-window walk of a group (window 2 or 4; see the header):
// take up to `window` L1 entries off the front, the nearest first, while
// they can beat the bound read when the window opened; slab-test their
// window x G children against that bound, entry q = j * G + c (window slot
// j, child c) on lane q mod W in registers; drain them nearest first by
// group minimum on (entry, q), so ties go to the L1 taken first, then the
// least child, `pops` children per read of the bound.  Every lane tests
// triangles lane, lane + W, ... of the drained child in the space of its
// L1 (the instance transform is recomputed per child: no per-slot ray is
// kept), and the group reduces its best hit; any-hit ends on a ballot.
// Returns true when an any-hit walk found an occluder.
template <int AMASK, bool INST, bool MOTION, int W, int N>
__device__ __forceinline__ bool window_walk(
    const Group<W>& g, Front2<N>& f, const Top& top, const Tabs& tb,
    const Ray& r, float time, float tmax0, int any_hit, int window, int pops,
    Best& best, int& n_pass, int& n_l1, int& n_leaf, int& n_mask,
    int& n_top) {
  constexpr int CPL = (WINDOW_MAX * 64 + W - 1) / W;   // entries per lane
  while (true) {
    const float cb = cull_bound<AMASK>(best);
    int wb[WINDOW_MAX] = {}, wbase[WINDOW_MAX] = {};
    int nw = 0;
    float he;
    int ho;
    while (nw < window &&
           front_head(g, f, top, r, cb, he, ho, n_pass, n_top) &&
           he <= cb * WIDEN) {
      front_take(f, he, ho);
#pragma unroll
      for (int j = 0; j < WINDOW_MAX; ++j)
        if (j == nw) wb[j] = ho >> 1;
      ++nw;
    }
    if (nw == 0) return false;   // front-to-back: no entry left can help
    n_l1 += nw;
    float ce[CPL];   // this lane's child entries, BIG_F32 once taken
#pragma unroll
    for (int s = 0; s < CPL; ++s) ce[s] = BIG_F32;
    for (int j = 0; j < nw; ++j) {
      const int b = pick(wb, j);
      if (tb.touched && g.lane == 0) tb.touched[b] = 1;
      const int base = tb.l1_base[INST ? tb.blk_src[b] : b];
#pragma unroll
      for (int k = 0; k < WINDOW_MAX; ++k)
        if (k == j) wbase[k] = base;
      const Ray rl = l1_ray<INST, MOTION>(tb, b, r, time);
#pragma unroll
      for (int s = 0; s < CPL; ++s) {
        const int c = g.lane + s * W - j * tb.g;
        if (c >= 0 && c < tb.g)
          ce[s] = slab_entry(tb.l2box + 2 * (base + c), rl, cb);
      }
    }
    bool left = true;
    while (left) {
      const float bnd = cull_bound<AMASK>(best) * WIDEN;
      for (int p = 0; p < pops; ++p) {
        float em = BIG_F32;
        int qm = INT_MAX;
#pragma unroll
        for (int s = 0; s < CPL; ++s)
          if (key_less(ce[s], g.lane + s * W, em, qm)) {
            em = ce[s];
            qm = g.lane + s * W;
          }
        group_min(g, em, qm);
        // drained, or nearest first: nothing left can help
        if (em >= BIG_F32 || em > bnd) {
          left = false;
          break;
        }
#pragma unroll
        for (int s = 0; s < CPL; ++s)
          if (qm == g.lane + s * W) ce[s] = BIG_F32;
        const int j = qm / tb.g, c = qm - j * tb.g;
        const int b = pick(wb, j), base = pick(wbase, j);
        const Ray rl = l1_ray<INST, MOTION>(tb, b, r, time);
        ++n_leaf;
        if (tb.touched && g.lane == 0) tb.touched[tb.m1 + base + c] = 1;
        Best lb = best;
        const bool any = test_leaf<AMASK, INST, MOTION>(
            tb.tri, tb.tri_mask, base + c, tb.k2, b,
            INST ? c * tb.k2 : (base + c) * tb.k2, rl, time, tmax0, lb,
            n_mask, g.lane, W);
        group_best<AMASK, INST, W>(g, lb);
        best = lb;
        if (any_hit && g.any(any)) return true;
      }
    }
  }
}

#ifndef TRACE2_LANES
#define TRACE2_LANES 8     // lanes per ray of the group walk
#endif
#ifndef TRACE2_WINDOW_LANES
#define TRACE2_WINDOW_LANES 16   // lanes per ray of the window walk
#endif
#ifndef TRACE2_WINDOW_BLOCKS
#define TRACE2_WINDOW_BLOCKS 6   // its __launch_bounds__ blocks per SM
#endif

// Ray i of the launch, with its reciprocals.
__device__ __forceinline__ Ray load_ray(const float* __restrict__ orig,
                                        const float* __restrict__ dirs,
                                        int i) {
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
  return r;
}

// A front with nothing filled yet: every lane is dry below a horizon
// under every key, so the first head refills from below every key.
template <int N>
__device__ __forceinline__ void front_start(Front2<N>& f) {
  front_clear(f.lane);
  f.lane.he = -1.0f;
  f.lane.ho = -1;
  f.ce = -1.0f;
  f.co = -1;
}

// Ray i's result and counters (written by lane 0 of its group).
template <int AMASK, bool INST>
__device__ __forceinline__ void store_result(
    const Best& best, int i, float* __restrict__ out_t,
    int* __restrict__ out_slot, int* __restrict__ out_blk,
    int* __restrict__ counters, int n_pass, int n_l1, int n_leaf, int n_mask,
    int n_top) {
  const bool solid = AMASK == 2 && best.t_opq < best.t;
  const bool hit = best.slot != NO_SLOT && !solid;
  out_t[i] = hit ? best.t : BIG_F32;
  out_slot[i] = solid ? -2 : (hit ? best.slot : -1);
  if (INST) out_blk[i] = hit ? best.blk : -1;
  if (counters) {
    counters[5 * i] = n_pass;
    counters[5 * i + 1] = n_l1;
    counters[5 * i + 2] = n_leaf;
    counters[5 * i + 3] = n_mask;
    counters[5 * i + 4] = n_top;
  }
}

// The group walk (window 1): one ray per W lanes.  The coarse table is
// staged in shared memory when `stage` (every thread of the block takes
// part before any group leaves).  At least 4 blocks per SM lets ptxas use
// up to 128 registers: it keeps the walk in 76-89 of them with no stack
// frame and no spills, where by its own choice it stops at 72-80 and
// spills (PERF.md, section 6).  At 80 or fewer (closest, amask 1 / 2) 6
// blocks fit an SM, above 80 only 5.
template <int AMASK, bool INST, bool MOTION, int W>
__global__ void __launch_bounds__(128, 4)
trace2_kernel(const float* __restrict__ orig, const float* __restrict__ dirs,
              const float* __restrict__ tmax, int n, Tabs tb,
              const float4* __restrict__ coarse, int nc,
              const int4* __restrict__ members,
              const int* __restrict__ union_of, int stage, int any_hit,
              const float* __restrict__ times, float* __restrict__ out_t,
              int* __restrict__ out_slot, int* __restrict__ out_blk,
              int* __restrict__ counters) {
  const Top top{tb.l1box, stage_rows(coarse, 2 * nc, stage != 0), nc,
                members, union_of};
  const Group<W> g;
  const int i = blockIdx.x * (blockDim.x / W) + threadIdx.x / W;
  if (i >= n) return;
  const Ray r = load_ray(orig, dirs, i);
  const float tmax0 = tmax[i];
  const float time = MOTION ? times[i] : 0.0f;
  Best best{tmax0, NO_SLOT, tmax0, NO_SLOT};
  int n_pass = 0, n_l1 = 0, n_leaf = 0, n_mask = 0, n_top = 0;
  if (tmax0 > 0.0f) {
    Front2<LaneFrontSize<W>::value> f;
    front_start(f);
    float he;
    int ho;
    while (true) {
      const float cb = cull_bound<AMASK>(best);
      // front-to-back: no entry left can help
      if (!front_head(g, f, top, r, cb, he, ho, n_pass, n_top) ||
          he > cb * WIDEN)
        break;
      front_take(f, he, ho);
      ++n_l1;
      if (visit_l1_group<AMASK, INST, MOTION, W>(g, tb, ho >> 1, r, time,
                                                 tmax0, any_hit, best, n_leaf,
                                                 n_mask))
        break;   // an any-hit walk found an occluder
    }
  }
  n_mask = group_sum(g, n_mask);
  n_top = group_sum(g, n_top);
  if (g.lane != 0) return;
  store_result<AMASK, INST>(best, i, out_t, out_slot, out_blk, counters,
                            n_pass, n_l1, n_leaf, n_mask, n_top);
}

// The resident-window walk (window 2 or 4): one ray per W lanes, on the
// group walk's front and staged coarse table.
template <int AMASK, bool INST, bool MOTION, int W>
__global__ void __launch_bounds__(128, TRACE2_WINDOW_BLOCKS)
trace2_window_kernel(const float* __restrict__ orig,
                     const float* __restrict__ dirs,
                     const float* __restrict__ tmax, int n, Tabs tb,
                     const float4* __restrict__ coarse, int nc,
                     const int4* __restrict__ members,
                     const int* __restrict__ union_of, int stage,
                     int any_hit, int window, int pops,
                     const float* __restrict__ times,
                     float* __restrict__ out_t, int* __restrict__ out_slot,
                     int* __restrict__ out_blk, int* __restrict__ counters) {
  const Top top{tb.l1box, stage_rows(coarse, 2 * nc, stage != 0), nc,
                members, union_of};
  const Group<W> g;
  const int i = blockIdx.x * (blockDim.x / W) + threadIdx.x / W;
  if (i >= n) return;
  const Ray r = load_ray(orig, dirs, i);
  const float tmax0 = tmax[i];
  const float time = MOTION ? times[i] : 0.0f;
  Best best{tmax0, NO_SLOT, tmax0, NO_SLOT};
  int n_pass = 0, n_l1 = 0, n_leaf = 0, n_mask = 0, n_top = 0;
  if (tmax0 > 0.0f) {
    Front2<LaneFrontSize<W>::value> f;
    front_start(f);
    window_walk<AMASK, INST, MOTION, W>(g, f, top, tb, r, time, tmax0,
                                        any_hit, window, pops, best, n_pass,
                                        n_l1, n_leaf, n_mask, n_top);
  }
  n_mask = group_sum(g, n_mask);
  n_top = group_sum(g, n_top);
  if (g.lane != 0) return;
  store_result<AMASK, INST>(best, i, out_t, out_slot, out_blk, counters,
                            n_pass, n_l1, n_leaf, n_mask, n_top);
}

}  // namespace

// mode = AMASK + 3 * INST + 6 * MOTION.  Masks and motion exclude each other.
#define TRACE2_MODES(X) \
  X(0, 0, false, false) X(1, 1, false, false) X(2, 2, false, false) \
  X(3, 0, true, false) X(4, 1, true, false) X(5, 2, true, false) \
  X(6, 0, false, true) X(9, 0, true, true)

// coarse / nc: the coarse unions ([nc, 8] f32: lo xyz, the bits of the
// least member, hi xyz, 0), members ([nc, COARSE_G] i32, ascending, -1
// padded), union_of ([m1] i32); every entry in exactly one union.  A window
// outside {1, 2, 4} or pops < 1 is refused.
extern "C" int trace2_launch(const float* orig, const float* dirs,
                             const float* tmax, int n, const float* l1box,
                             int m1, const float* coarse, int nc,
                             const int* members, const int* union_of,
                             const int* l1_base, const float* l2box,
                             const float* tri, const int* mask, int k2, int g,
                             int any_hit, int amask, const int* blk_src,
                             const int* blk_inst, const float* inst_inv,
                             const float* inst_velo, const float* times,
                             int window, int pops, float* out_t,
                             int* out_slot, int* out_blk, int* counters,
                             unsigned char* touched, void* stream) {
  if (n <= 0) return 0;
  const bool inst = blk_src != nullptr;
  const bool motion = times != nullptr;
  if (amask < 0 || amask > 2 ||
      (amask && (any_hit || mask == nullptr || motion)) ||
      (inst && (!blk_inst || !inst_inv || !out_blk || (motion && !inst_velo))))
    return (int)cudaErrorInvalidValue;
  if (g < 1 || g > 64 || pops < 1 ||
      (window != 1 && window != 2 && window != 4) ||
      !coarse || !members || !union_of || nc < 1 || nc > m1)
    return (int)cudaErrorInvalidValue;
  Tabs tb{(const float4*)l1box, m1, l1_base, (const float4*)l2box,
          (const float4*)tri, (const int4*)mask, k2, g, blk_src, blk_inst,
          inst_inv, inst_velo, touched};
  const int stage = nc * 32 <= STAGE_MAX_BYTES;
  const int smem = stage ? nc * 32 : 0;
  switch (amask + 3 * (int)inst + 6 * (int)motion) {
#define TRACE2_CASE(MODE, AMASK, INST, MOTION)                               \
  case MODE:                                                                 \
    if (window > 1)                                                          \
      return launch_groups<TRACE2_WINDOW_LANES>(                             \
          trace2_window_kernel<AMASK, INST, MOTION, TRACE2_WINDOW_LANES>, n, \
          smem, stream, orig, dirs, tmax, n, tb, (const float4*)coarse, nc,  \
          (const int4*)members, union_of, stage, any_hit, window, pops,      \
          times, out_t, out_slot, out_blk, counters);                        \
    return launch_groups<TRACE2_LANES>(                                      \
        trace2_kernel<AMASK, INST, MOTION, TRACE2_LANES>, n, smem, stream,   \
        orig, dirs, tmax, n, tb, (const float4*)coarse, nc,                  \
        (const int4*)members, union_of, stage, any_hit, times, out_t,        \
        out_slot, out_blk, counters);
    TRACE2_MODES(TRACE2_CASE)
#undef TRACE2_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Blocks of 128 threads per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// of mode `mode`'s group kernel (window = 0) or of its window kernel
// (window = 1), with `smem` bytes of staged coarse table.
extern "C" int trace2_occupancy(int mode, int window, int smem, int* blocks) {
#ifdef __CUDACC__
  switch (mode) {
#define TRACE2_OCC(MODE, AMASK, INST, MOTION)                                 \
  case MODE:                                                                  \
    return (int)(window ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(      \
                              blocks,                                         \
                              trace2_window_kernel<AMASK, INST, MOTION,       \
                                                   TRACE2_WINDOW_LANES>,      \
                              128, smem)                                      \
                        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(      \
                              blocks,                                         \
                              trace2_kernel<AMASK, INST, MOTION,              \
                                            TRACE2_LANES>,                    \
                              128, smem));
    TRACE2_MODES(TRACE2_OCC)
#undef TRACE2_OCC
    default:
      return (int)cudaErrorInvalidValue;
  }
#else
  (void)mode, (void)window, (void)smem, (void)blocks;
  return (int)cudaErrorInvalidValue;
#endif
}
