// The dispatch sort key for Hopper (sm_90a): scene/intersect.py's
// _first_block_key (the flat slab of _slab_top2 and the key's tail) as one
// launch that writes the finished int64 key.
//
// Replaces no TPU kernel.  The JAX package's key
// (pathtracing_tpu/scene/intersect.py::_first_block_key, its _slab_top2) is
// plain jnp that XLA fuses into the jitted render: a slab test of every ray
// against every L1 box, 512 boxes a chunk.  Run eagerly by PyTorch, each
// chunk is ~27 ops that each write an [N, 512] tensor (134 MB at 65,280
// rays): at 2,563 L1s, ~160 launches and ~8 GB of device traffic a call.
//
// Bound on the H100: operations.  N x mp slab tests (mp: the box count
// padded to a multiple of 512) of 20 fp32 operations each (the count
// tools/roofline.py gives a slab test): 65,280 x 3,072 x 20 = 4.0 GFLOP,
// 0.060 ms at 67 TFLOP/s.  Bytes: each ray's origin and direction read once
// and its key written once (32 B), the box table from L2: ~2 MB, 0.6 us.
//
// Design: one thread per ray, SORTKEY_THREADS rays a block.  The block
// stages the box table through shared memory one tile of SORTKEY_TILE = 512
// boxes (12 KB) at a time, the padding boxes included; each thread keeps its
// origin, 1 / direction, the tile's top two and the running top two in
// registers, and writes its key once.  The tail (octant, the runner-up
// rule, the first-block-only key of huge tables, the miss sentinel) runs in
// the same thread.
//
// Bits: the plain version's.  The key orders work and never changes a
// result, but the dispatch's permutation, and with it every count, stays the
// plain key's only if the key does, so:
//   - tiles of 512 in id order are the plain version's chunks, merged by its
//     rule: within a chunk ties go to the lowest index (torch.min over dim
//     1), for the best and for the runner-up, which is the minimum over the
//     chunk with the best's entry set to BIG; across chunks the older best
//     wins a tie for the best, and a tie for the runner-up goes to the loser
//     of the bests over the winner's own runner-up (`alt_e <= sec_e`).  Ties
//     are common: a ray whose origin lies inside several boxes enters each
//     at t = 0;
//   - the padding boxes (3e37 corners) are tested like any box: a ray along
//     (1, 1, 1) enters one below BIG and may take it as the runner-up;
//   - (lo - o) * inv rounded twice (built with --fmad=false), inv = 1 / d
//     with d's magnitudes under 1e-32 replaced by +-1e-32, min and max that
//     return NaN for a NaN operand as torch.minimum / maximum / clamp do, and
//     tn <= tf as written.
//
// The host build (accel/cubuild.py::host_library) stages the same tiles and
// runs the same scan, once per ray, for the CPU tests.

#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#define SORTKEY_THREADS 256
#define SORTKEY_TILE 512
#define SORTKEY_BIG 3.0e38f       // core/math.py's BIG_F32
#define SORTKEY_HALF_BIG 1.5e38f  // BIG_F32 * 0.5
#define SORTKEY_PAD 3e37f         // the padding boxes' corners
#define SORTKEY_MISS 0x7FFFFFFELL

struct SortKeyArgs {
  const float* lo;   // [m, 3]
  const float* hi;   // [m, 3]
  const float* o;    // [n, 3], rows os apart
  const float* d;    // [n, 3], rows ds apart
  int64_t m, mp, n, os, ds;
  int64_t* out;      // [n]
};

struct Top2 {
  float e1, e2;
  int64_t i1, i2;
};

#ifdef __CUDACC__
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
#else
inline float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}
inline float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : (b > a ? b : a));
}
#endif

// box j of the table (a padding box from m on) into a tile's slot s, as
// lo.xyz hi.xyz
__device__ __forceinline__ void stage_box(float* tile, int s,
                                          const SortKeyArgs& a, int64_t j) {
  float* t = tile + 6 * s;
  if (j < a.m) {
    for (int k = 0; k < 3; ++k) {
      t[k] = a.lo[3 * j + k];
      t[3 + k] = a.hi[3 * j + k];
    }
  } else {
    for (int k = 0; k < 6; ++k) t[k] = SORTKEY_PAD;
  }
}

// the entry distance of the ray into a box, SORTKEY_BIG where it misses
__device__ __forceinline__ float slab(float lx, float ly, float lz, float hx,
                                      float hy, float hz, const float* o,
                                      const float* inv) {
  float u0 = (lx - o[0]) * inv[0];
  float u1 = (hx - o[0]) * inv[0];
  float tn = nan_min(u0, u1);
  float tf = nan_max(u0, u1);
  u0 = (ly - o[1]) * inv[1];
  u1 = (hy - o[1]) * inv[1];
  tn = nan_max(tn, nan_min(u0, u1));
  tf = nan_min(tf, nan_max(u0, u1));
  u0 = (lz - o[2]) * inv[2];
  u1 = (hz - o[2]) * inv[2];
  tn = nan_max(nan_max(tn, nan_min(u0, u1)), 0.0f);
  tf = nan_min(tf, nan_max(u0, u1));
  return tn <= tf ? tn : SORTKEY_BIG;
}

// one chunk's top two (torch.min over dim 1, then again with the best's
// entry set to BIG), merged into the running top two as _slab_top2 merges
__device__ __forceinline__ void scan_tile(const float4* tile, int64_t base,
                                          const float* o, const float* inv,
                                          Top2& run) {
  // c: the first minimum; x: the first minimum of the others.  The plain
  // version's runner-up sets the best's entry to BIG instead of leaving it
  // out, and its entries may reach INF: the two differ only where every
  // other entry is at BIG or above, where the key reads neither index
  const float inf = __int_as_float(0x7F800000);
  float c1e = inf, x2e = inf;
  int c1i = 0, x2i = 0;
#pragma unroll 4
  for (int p = 0; p < SORTKEY_TILE / 2; ++p) {
    const float4 a = tile[3 * p], b = tile[3 * p + 1], c = tile[3 * p + 2];
    const float ea = slab(a.x, a.y, a.z, a.w, b.x, b.y, o, inv);
    const float eb = slab(b.z, b.w, c.x, c.y, c.z, c.w, o, inv);
    const int j = 2 * p;
    bool n1 = ea < c1e, n2 = ea < x2e;
    x2e = n1 ? c1e : (n2 ? ea : x2e);
    x2i = n1 ? c1i : (n2 ? j : x2i);
    c1e = n1 ? ea : c1e;
    c1i = n1 ? j : c1i;
    n1 = eb < c1e;
    n2 = eb < x2e;
    x2e = n1 ? c1e : (n2 ? eb : x2e);
    x2i = n1 ? c1i : (n2 ? j + 1 : x2i);
    c1e = n1 ? eb : c1e;
    c1i = n1 ? j + 1 : c1i;
  }
  const float ce = c1e, ce2 = x2e;
  const int64_t ci = base + c1i, cj = base + x2i;
  // the plain version's merge, step for step
  const bool old1 = run.e1 <= ce;
  const float t1e = old1 ? run.e1 : ce;
  const int64_t t1i = old1 ? run.i1 : ci;
  const float alt_e = old1 ? ce : run.e1;
  const int64_t alt_i = old1 ? ci : run.i1;
  const float sec_e = old1 ? run.e2 : ce2;
  const int64_t sec_i = old1 ? run.i2 : cj;
  const bool t2o = alt_e <= sec_e;
  run.e2 = t2o ? alt_e : sec_e;
  run.i2 = t2o ? alt_i : sec_i;
  run.e1 = t1e;
  run.i1 = t1i;
}

__device__ __forceinline__ void load_ray(const SortKeyArgs& a, int64_t i,
                                         float* o, float* inv, int& octant) {
  octant = 0;
  for (int k = 0; k < 3; ++k) {
    o[k] = a.o[i * a.os + k];
    const float d = a.d[i * a.ds + k];
    const float g = fabsf(d) < 1e-32f ? (d < 0.0f ? -1e-32f : 1e-32f) : d;
    inv[k] = 1.0f / g;
    octant |= (d > 0.0f ? 1 : 0) << k;
  }
}

__device__ __forceinline__ int64_t key_of(const SortKeyArgs& a,
                                          const Top2& r, int octant) {
  if (r.e1 >= SORTKEY_HALF_BIG) return SORTKEY_MISS;
  if (8 * a.m * a.m >= (1LL << 31))  // huge block counts: first block only
    return (r.i1 << 3) | octant;
  const int64_t hi = a.m - 1;
  const int64_t b2 = r.e2 >= SORTKEY_HALF_BIG
                         ? r.i1
                         : (r.i2 < 0 ? 0 : (r.i2 > hi ? hi : r.i2));
  return ((r.i1 * a.m + b2) * 8) | octant;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(SORTKEY_THREADS)
    sortkey_kernel(const SortKeyArgs a) {
  __shared__ float4 tile[SORTKEY_TILE * 6 / 4];
  const int64_t i = (int64_t)blockIdx.x * SORTKEY_THREADS + threadIdx.x;
  const bool live = i < a.n;
  float o[3] = {0.f, 0.f, 0.f}, inv[3] = {1.f, 1.f, 1.f};
  int octant = 0;
  if (live) load_ray(a, i, o, inv, octant);
  Top2 run = {SORTKEY_BIG, SORTKEY_BIG, 0, 0};
  for (int64_t base = 0; base < a.mp; base += SORTKEY_TILE) {
    __syncthreads();  // every thread is done with the last tile
    for (int s = threadIdx.x; s < SORTKEY_TILE; s += SORTKEY_THREADS)
      stage_box((float*)tile, s, a, base + s);
    __syncthreads();
    if (live) scan_tile(tile, base, o, inv, run);
  }
  if (live) a.out[i] = key_of(a, run, octant);
}
#endif

// lo, hi: [m, 3] float32, contiguous; o, d: [n, 3] float32 with unit column
// stride, rows os / ds floats apart; out: [n] int64.  Returns the launch's
// cudaError (0: launched).
extern "C" int sortkey_launch(const float* lo, const float* hi, long long m,
                              const float* o, const float* d, long long n,
                              long long os, long long ds, long long* out,
                              void* stream) {
  if (n <= 0) return 0;
  if (m < 0 || !out || !o || !d || (m > 0 && (!lo || !hi)))
    return (int)cudaErrorInvalidValue;
  SortKeyArgs a;
  a.lo = lo;
  a.hi = hi;
  a.o = o;
  a.d = d;
  a.m = m;
  a.mp = (m + SORTKEY_TILE - 1) / SORTKEY_TILE * SORTKEY_TILE;
  a.n = n;
  a.os = os;
  a.ds = ds;
  a.out = (int64_t*)out;
#ifdef __CUDACC__
  const unsigned blocks =
      (unsigned)((n + SORTKEY_THREADS - 1) / SORTKEY_THREADS);
  sortkey_kernel<<<blocks, SORTKEY_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
#else
  (void)stream;
  static float4 tile[SORTKEY_TILE * 6 / 4];
  for (int64_t i = 0; i < n; ++i) {
    float o3[3], inv[3];
    int octant;
    load_ray(a, i, o3, inv, octant);
    Top2 run = {SORTKEY_BIG, SORTKEY_BIG, 0, 0};
    for (int64_t base = 0; base < a.mp; base += SORTKEY_TILE) {
      for (int s = 0; s < SORTKEY_TILE; ++s)
        stage_box((float*)tile, s, a, base + s);
      scan_tile(tile, base, o3, inv, run);
    }
    a.out[i] = key_of(a, run, octant);
  }
  return 0;
#endif
}
