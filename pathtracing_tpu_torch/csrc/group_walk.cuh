// The group walk of the traversal kernels (csrc/trace2.cu, the two-level
// walk, and csrc/trace1.cu, the single-level one): W lanes per ray and a
// front over the coarse unions of the top level (trace2's L1 entries,
// trace1's blocks; "L1 entry" below stands for either).  Included after
// trace_common.cuh; the leaf micro-benchmark does not use it.
//
// Group primitives.  A group is W consecutive lanes of a warp (W a power of
// two dividing 32) that walk one ray together; every decision of the walk
// is taken on values the group agrees on (results of the reductions below),
// so the group never diverges and each primitive is met by all its lanes.
// On the card the primitives are warp shuffles and ballots over the group's
// lane mask.  The host build (accel/cubuild.py::host_library, no GPU) runs
// each ray's W lanes as W std::threads that meet at a C++20 std::barrier in
// each primitive, so the same walk runs on the CPU.
//
// The coarse front.  The top-level order of the walk is the flat (entry,
// index) order over the L1 entries, the order of the one-thread walk
// (entries as accel/trace2.py::slab_entries computes them).  It is produced
// from unions of up to COARSE_G L1 entries (the wrapper's pk_cbox with its
// member lists pk_cmem: consecutive entries of world tables, entries near
// each other in SAH order for instanced ones): a union enters the front
// with key (its entry, its least member) and, when it reaches the head, is
// replaced by its entered members.  Two facts make this exact, both under
// the very same float operations of slab_entry:
//   (1) a union box's entry is <= each member's entry (every slab bound of
//       the union is at least as wide: min / max, multiplication by the
//       reciprocal and the clamps are all monotone);
//   (2) a member that is entered has its union entered (the member's entry
//       <= its exit * WIDEN <= the union's exit * WIDEN).
// So the union's key is <= every member's key, and no member can be due
// before its union is expanded.  Keys are (entry, ord) with ord = 2 * b0
// for a union whose least member is b0 and 2 * b + 1 for entry b, which
// orders a union before its own members at an equal entry and members by
// index.

#pragma once

#include <climits>
#ifndef __CUDACC__
#include <barrier>
#include <cstring>
#include <thread>
#endif

namespace {

constexpr int COARSE_G = 8;   // L1 entries per coarse union (SORT_COARSE_G)
// The coarse table is staged in shared memory up to this size
// (accel/trace2.py::STAGE_MAX_BYTES mirrors it).
constexpr int STAGE_MAX_BYTES = 16384;

#ifdef __CUDACC__

template <int W>
struct Group {
  unsigned mask;   // the group's lanes in the warp
  int lane;        // 0 .. W-1
  __device__ __forceinline__ Group()
      : mask(W == 32 ? 0xffffffffu
                     : ((1u << W) - 1u) << ((threadIdx.x & 31) & ~(W - 1))),
        lane(threadIdx.x & (W - 1)) {}
  __device__ __forceinline__ float xor_lane(float x, int off) const {
    return __shfl_xor_sync(mask, x, off, W);
  }
  __device__ __forceinline__ int xor_lane(int x, int off) const {
    return __shfl_xor_sync(mask, x, off, W);
  }
  __device__ __forceinline__ bool any(bool p) const {
    return __ballot_sync(mask, p) != 0u;
  }
};

#else   // host build: W threads per ray, one barrier per primitive

struct HostGroupState {
  std::barrier<>* bar;
  int word[32];
};
thread_local HostGroupState* host_group = nullptr;

template <int W>
struct Group {
  unsigned mask = 0;
  int lane = threadIdx.x & (W - 1);
  // every lane posts its word, then reads lane ^ off's
  int swap(int x, int off) const {
    if (W == 1) return x;
    HostGroupState& h = *host_group;
    h.word[lane] = x;
    h.bar->arrive_and_wait();
    const int y = h.word[lane ^ off];
    h.bar->arrive_and_wait();
    return y;
  }
  float xor_lane(float x, int off) const {
    int i;
    std::memcpy(&i, &x, 4);
    i = swap(i, off);
    std::memcpy(&x, &i, 4);
    return x;
  }
  int xor_lane(int x, int off) const { return swap(x, off); }
  bool any(bool p) const {
    if (W == 1) return p;
    HostGroupState& h = *host_group;
    h.word[lane] = p;
    h.bar->arrive_and_wait();
    bool a = false;
    for (int j = 0; j < W; ++j) a = a || h.word[j] != 0;
    h.bar->arrive_and_wait();
    return a;
  }
};

#endif

__device__ __forceinline__ bool key_less(float e0, int o0, float e1, int o1) {
  return e0 < e1 || (e0 == e1 && o0 < o1);
}

// The least (e, o) over the group, in every lane.
template <int W>
__device__ __forceinline__ void group_min(const Group<W>& g, float& e,
                                          int& o) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) {
    const float e2 = g.xor_lane(e, off);
    const int o2 = g.xor_lane(o, off);
    if (key_less(e2, o2, e, o)) {
      e = e2;
      o = o2;
    }
  }
}

template <int W>
__device__ __forceinline__ int group_sum(const Group<W>& g, int x) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) x += g.xor_lane(x, off);
  return x;
}

// The group's best hit: the least (t, expanded block, slot) (plain tables:
// (t, slot)), the tie rule of test_leaf, and the least opaque t (AMASK=2).
template <int AMASK, bool INST, int W>
__device__ __forceinline__ void group_best(const Group<W>& g, Best& b) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) {
    const float t = g.xor_lane(b.t, off);
    const int slot = g.xor_lane(b.slot, off);
    const int blk = INST ? g.xor_lane(b.blk, off) : 0;
    bool better = t < b.t;
    if (t == b.t)
      better = INST ? (blk < b.blk || (blk == b.blk && slot < b.slot))
                    : slot < b.slot;
    if (better) {
      b.t = t;
      b.slot = slot;
      if (INST) b.blk = blk;
    }
    if (AMASK == 2) b.t_opq = fminf(b.t_opq, g.xor_lane(b.t_opq, off));
  }
}

// One lane's part of the front: the N least keys of its own items above the
// cursor, sorted, in registers (every index below is a constant after
// unrolling).  Empty slots hold (BIG_F32, INT_MAX), above every real item.
// The horizon (he, ho) is the least key this lane dropped since its last
// refill ((BIG_F32, INT_MAX): none): every item of the lane above the
// cursor that is not held is at or beyond it, and every held item is below
// it, so an item at or beyond it is dropped too.  A lane that holds nothing
// below a horizon has to be refilled.
template <int N>
struct LaneFront {
  float e[N];
  int o[N];
  float he;
  int ho;
};

template <int N>
__device__ __forceinline__ void front_clear(LaneFront<N>& f) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    f.e[k] = BIG_F32;
    f.o[k] = INT_MAX;
  }
  f.he = BIG_F32;
  f.ho = INT_MAX;
}

template <int N>
__device__ __forceinline__ bool front_dry(const LaneFront<N>& f) {
  return f.e[0] >= BIG_F32 && f.ho != INT_MAX;
}

template <int N>
__device__ __forceinline__ void front_insert(LaneFront<N>& f, float e,
                                             int o) {
  if (!key_less(e, o, f.he, f.ho)) return;          // beyond the horizon
  if (!key_less(e, o, f.e[N - 1], f.o[N - 1])) {   // full, and e is last
    f.he = e;
    f.ho = o;
    return;
  }
  if (f.e[N - 1] < BIG_F32) {                      // the last one falls out
    f.he = f.e[N - 1];
    f.ho = f.o[N - 1];
  }
#pragma unroll
  for (int k = N - 1; k > 0; --k) {
    const bool shift = key_less(e, o, f.e[k - 1], f.o[k - 1]);
    const bool here = !shift && key_less(e, o, f.e[k], f.o[k]);
    f.e[k] = shift ? f.e[k - 1] : (here ? e : f.e[k]);
    f.o[k] = shift ? f.o[k - 1] : (here ? o : f.o[k]);
  }
  if (key_less(e, o, f.e[0], f.o[0])) {
    f.e[0] = e;
    f.o[0] = o;
  }
}

template <int N>
__device__ __forceinline__ void front_pop(LaneFront<N>& f) {
#pragma unroll
  for (int k = 0; k < N - 1; ++k) {
    f.e[k] = f.e[k + 1];
    f.o[k] = f.o[k + 1];
  }
  f.e[N - 1] = BIG_F32;
  f.o[N - 1] = INT_MAX;
}

// Registers per lane for its part of the front: 16 entries for one lane,
// fewer for more lanes (the group holds 32 with W = 8).
template <int W>
struct LaneFrontSize {
  static constexpr int value = W >= 8 ? 4 : (W >= 4 ? 8 : 16);
};

// The top level of one launch: the L1 entries (trace1: the blocks) and
// their coarse unions (in shared memory when staged).
struct Top {
  const float4* l1box;   // [m1, 2] (lo, hi)
  const float4* coarse;  // [nc, 2] union (lo, least member's bits; hi, 0)
  int nc;
  const int4* members;   // [nc, 2]: each union's members, ascending, -1 pad
  const int* union_of;   // [m1]: the union of each entry
};

// Insert the entered members of union c whose keys are above the cursor.
template <int N>
__device__ __forceinline__ void expand_union(LaneFront<N>& f, const Top& top,
                                             int c, const Ray& r, float bound,
                                             float ce, int co, int& n_top) {
  const int4 m0 = __ldg(top.members + 2 * c);
  const int4 m1 = __ldg(top.members + 2 * c + 1);
  const int mb[COARSE_G] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
  for (int k = 0; k < COARSE_G; ++k) {
    const int b = mb[k];
    if (b < 0) break;
    const float e = slab_entry(top.l1box + 2 * b, r, bound);
    ++n_top;
    if (e < BIG_F32 && key_less(ce, co, e, 2 * b + 1))
      front_insert(f, e, 2 * b + 1);
  }
}

// Refill every lane's part of the front with its items above the cursor
// (ce, co): lane j owns unions j, j + W, ... and their members.  A union
// above the cursor enters as itself; one at or below it was expanded
// before, so its members above the cursor enter.
template <int W, int N>
__device__ __forceinline__ void front_refill(const Group<W>& g,
                                             LaneFront<N>& f, const Top& top,
                                             const Ray& r, float bound,
                                             float ce, int co, int& n_top) {
  front_clear(f);
  for (int c = g.lane; c < top.nc; c += W) {
    const float4* u = top.coarse + 2 * c;
    const float4 lo = u[0];
    const float e = slab_entry(lo, u[1], r, bound);
    ++n_top;
    if (e >= BIG_F32) continue;
    const int ord = 2 * __float_as_int(lo.w);
    if (key_less(ce, co, e, ord))
      front_insert(f, e, ord);
    else
      expand_union(f, top, c, r, bound, ce, co, n_top);
  }
}

// The group's front: each lane's part and the cursor (the key of the last
// item taken off the front).
template <int N>
struct Front2 {
  LaneFront<N> lane;
  float ce;
  int co;
};

// The head of the front, in every lane: true with (he, ho) the least key
// left, where unions at or within `bound` * WIDEN are replaced by their
// members first, so the head is an L1 entry (ho odd, index ho >> 1) or
// lies beyond the bound.  False when nothing is left.  A lane whose part
// ran dry below its horizon makes the group refill from the cursor.
template <int W, int N>
__device__ __forceinline__ bool front_head(const Group<W>& g, Front2<N>& f,
                                           const Top& top, const Ray& r,
                                           float bound, float& he, int& ho,
                                           int& n_pass, int& n_top) {
  while (true) {
    if (g.any(front_dry(f.lane))) {
      front_refill(g, f.lane, top, r, bound, f.ce, f.co, n_top);
      ++n_pass;
    }
    he = f.lane.e[0];
    ho = f.lane.o[0];
    group_min(g, he, ho);
    if (he >= BIG_F32) return false;
    if ((ho & 1) || he > bound * WIDEN) return true;
    if (f.lane.o[0] == ho) {   // the union's owner replaces it
      front_pop(f.lane);
      expand_union(f.lane, top, __ldg(top.union_of + (ho >> 1)), r, bound,
                   he, ho, n_top);
    }
    f.ce = he;
    f.co = ho;
  }
}

// Take the head (an L1 entry) off the front.
template <int N>
__device__ __forceinline__ void front_take(Front2<N>& f, float he, int ho) {
  if (f.lane.o[0] == ho) front_pop(f.lane);
  f.ce = he;
  f.co = ho;
}

#ifdef __CUDACC__
// The rows [0, n4) of `src` staged in the block's shared memory with
// cp.async (every thread of the block must call this), or `src` itself when
// not staged.
__device__ __forceinline__ const float4* stage_rows(const float4* src, int n4,
                                                    bool stage) {
  extern __shared__ float4 staged_rows[];
  if (!stage) return src;
  for (int k = threadIdx.x; k < n4; k += blockDim.x) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(staged_rows + k);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src + k));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  return staged_rows;
}

// Launch `kernel` with W lanes per ray, 128 threads per block.
template <int W, typename... P, typename... A>
int launch_groups(void (*kernel)(P...), int n_rays, int smem, void* stream,
                  A... args) {
  const int per_block = 128 / W;
  kernel<<<(n_rays + per_block - 1) / per_block, 128, smem,
           (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}
#else
inline const float4* stage_rows(const float4* src, int, bool) { return src; }

// The host's launch: W threads, each one lane of every ray in turn; all
// meet at the end of each ray.
template <int W, typename... P, typename... A>
int launch_groups(void (*kernel)(P...), int n_rays, int, void*, A... args) {
  std::barrier<> bar(W);
  HostGroupState state{&bar, {}};
  auto lane = [&](int j) {
    host_group = &state;
    threadIdx.x = j;
    blockDim.x = W;
    for (int i = 0; i < n_rays; ++i) {
      blockIdx.x = i;
      kernel(args...);
      if (W > 1) bar.arrive_and_wait();
    }
  };
  if (W == 1) {
    lane(0);
    return 0;
  }
  std::thread th[W];
  for (int j = 0; j < W; ++j) th[j] = std::thread(lane, j);
  for (int j = 0; j < W; ++j) th[j].join();
  return 0;
}
#endif

}  // namespace
