// The sampler's hash stream for Hopper (sm_90a): core/rng.py's hash_u32,
// hash_float, sample_1d and sample_2d, each one launch.
//
// Replaces no TPU kernel.  The JAX package's sampler
// (pathtracing_tpu/core/rng.py) is integer arithmetic that XLA fuses into
// the jitted render.  Run eagerly by PyTorch, the same arithmetic on int64
// tensors is 79 to 504 small launches a call, and every Python int it mixes
// with a tensor is a copy to the card that the host waits for: ~3,900
// launches and ~69 host syncs per bounce iteration of the wavefront.
//
// Bound on the H100: bytes, and in practice the launch itself.  A lane reads
// at most four int64 keys and writes an int64, a float32 or a float32 pair:
// at most 40 B, 2.6 MB for 65,280 lanes, 0.78 us at 3.35 TB/s.  Its
// arithmetic (a few hundred 32-bit integer operations) is far below the
// card's integer rate.
//
// Design: one thread per lane computes the whole stream in registers:
// hash_u32's fold of mix32 over the keys; for the stratified kind the
// stratum seed hash_u32(px, py, dim, seed), the Kensler permutation_element
// of the sample index and the jitter hashes hash_u32(px, py, sample, dim,
// axis, seed ^ 0x5BF03635); uniform_from_u32; then (stratum + u) / spp or
// the 2-D split ((sx + dx) / x_samples, (sy + dy) / y_samples).  Keys that
// are the same for every lane (Python ints) are kernel arguments, so
// nothing is copied to the card; a 0-d tensor key is read through a zero
// stride, so the host never reads a device value.
//
// Bits: the plain version's.  Its int64-held u32 arithmetic is uint32_t
// arithmetic here; the float steps are one IEEE add and one IEEE divide in
// float32 (built with --fmad=false; nothing to contract).  For a strata
// count that is not a power of two, permutation_element's rejection loop
// over the whole batch becomes a loop per lane, with the same sequence of
// rounds per lane, capped at SAMPLER_MAX_ROUNDS rounds: the cap can bite
// only where the plain loop never returns (ROADMAP, "sampler loops
// forever"), and it turns that hang into a bounded kernel.
//
// The host build (accel/cubuild.py::host_library) runs the same lane
// function in a loop over the lanes, for the CPU tests.

#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#define SAMPLER_MAX_KEYS 8
#define SAMPLER_MAX_ROUNDS 4096
#define SAMPLER_THREADS 256

// ops (core/rng.py::_OPS)
#define SAMPLER_HASH_U32 0
#define SAMPLER_HASH_FLOAT 1
#define SAMPLER_1D 2
#define SAMPLER_2D 3

struct SamplerArgs {
  const int64_t* key[SAMPLER_MAX_KEYS];  // a tensor key, else nullptr
  int64_t step[SAMPLER_MAX_KEYS];        // 1 for an [n] key, 0 for a 0-d one
  uint32_t val[SAMPLER_MAX_KEYS];        // a constant key (low 32 bits)
  int nkeys, op, stratified;
  uint32_t xs, ys, seed;
  int64_t n;
  void* out;
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t fold(uint32_t h, uint32_t a) {
  return mix32(h ^ a ^ (h << 6) ^ (h >> 2));
}

__device__ __forceinline__ uint32_t key_at(const SamplerArgs& a, int j,
                                           int64_t i) {
  return a.key[j] ? (uint32_t)a.key[j][i * a.step[j]] : a.val[j];
}

// (h >> 8) * 2^-24: exact
__device__ __forceinline__ float uniform_from_u32(uint32_t h) {
  return (float)(h >> 8) * 5.9604644775390625e-8f;
}

__device__ __forceinline__ uint32_t perm_round(uint32_t i, uint32_t p,
                                               uint32_t w) {
  i ^= p;
  i *= 0xE170893Du;
  i ^= p >> 16;
  i ^= (i & w) >> 4;
  i ^= p >> 8;
  i *= 0x0929EB3Fu;
  i ^= p >> 23;
  i ^= (i & w) >> 1;
  i *= 1u | (p >> 27);
  i *= 0x6935FA69u;
  i ^= (i & w) >> 11;
  i *= 0x74DCB303u;
  i ^= (i & w) >> 2;
  i *= 0x9E501CC3u;
  i ^= (i & w) >> 2;
  i *= 0xC860A3DFu;
  i &= w;
  i ^= i >> 5;
  return i;
}

__device__ __forceinline__ uint32_t permutation_element(uint32_t i,
                                                        uint32_t l,
                                                        uint32_t p) {
  uint32_t w = l - 1;
  w |= w >> 1;
  w |= w >> 2;
  w |= w >> 4;
  w |= w >> 8;
  w |= w >> 16;
  i = perm_round(i, p, w);
  if (l & (l - 1))
    for (int r = 0; i >= l && r < SAMPLER_MAX_ROUNDS; ++r)
      i = perm_round(i, p, w);
  return (i + p) % l;
}

__device__ __forceinline__ void sampler_lane(const SamplerArgs& a,
                                             int64_t i) {
  if (a.op == SAMPLER_HASH_U32 || a.op == SAMPLER_HASH_FLOAT) {
    uint32_t h = 0x9E3779B9u;
    for (int j = 0; j < a.nkeys; ++j) h = fold(h, key_at(a, j, i));
    if (a.op == SAMPLER_HASH_U32)
      ((int64_t*)a.out)[i] = (int64_t)h;
    else
      ((float*)a.out)[i] = uniform_from_u32(h);
    return;
  }
  const uint32_t px = key_at(a, 0, i), py = key_at(a, 1, i);
  const uint32_t si = key_at(a, 2, i), dim = key_at(a, 3, i);
  // the jitter of one axis: hash_u32(px, py, sample, dim, axis, seed ^ C)
  uint32_t base = fold(fold(fold(fold(0x9E3779B9u, px), py), si), dim);
  const uint32_t jseed = a.seed ^ 0x5BF03635u;
  const float u0 = uniform_from_u32(fold(fold(base, 0u), jseed));
  const bool two = a.op == SAMPLER_2D;
  const float u1 = two ? uniform_from_u32(fold(fold(base, 1u), jseed)) : 0.f;
  float* out = (float*)a.out;
  if (!a.stratified) {
    if (two) {
      out[2 * i] = u0;
      out[2 * i + 1] = u1;
    } else {
      out[i] = u0;
    }
    return;
  }
  const uint32_t l = a.xs * a.ys;
  const uint32_t seed =
      fold(fold(fold(fold(0x9E3779B9u, px), py), dim), a.seed);
  const uint32_t stratum = permutation_element(si, l, seed);
  if (two) {
    out[2 * i] = ((float)(stratum % a.xs) + u0) / (float)a.xs;
    out[2 * i + 1] = ((float)(stratum / a.xs) + u1) / (float)a.ys;
  } else {
    out[i] = ((float)stratum + u0) / (float)l;
  }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(SAMPLER_THREADS)
    sampler_kernel(const SamplerArgs a) {
  const int64_t i = (int64_t)blockIdx.x * SAMPLER_THREADS + threadIdx.x;
  if (i < a.n) sampler_lane(a, i);
}
#endif

// keys[j] (a device address, or 0 for a constant), steps[j] and vals[j] for
// j < nkeys; out is [n] (int64 for HASH_U32, else float32) or [n, 2]
// float32 (SAMPLER_2D).  Returns the launch's cudaError (0: launched).
extern "C" int sampler_launch(int op, long long n, int nkeys,
                              const long long* keys, const long long* steps,
                              const unsigned* vals, int stratified,
                              unsigned xs, unsigned ys, unsigned seed,
                              void* out, void* stream) {
  if (n <= 0) return 0;
  if (op < SAMPLER_HASH_U32 || op > SAMPLER_2D || nkeys < 0 ||
      nkeys > SAMPLER_MAX_KEYS || (op >= SAMPLER_1D && nkeys != 4) ||
      (op >= SAMPLER_1D && stratified && (xs == 0 || ys == 0)) || !out)
    return (int)cudaErrorInvalidValue;
  SamplerArgs a;
  for (int j = 0; j < SAMPLER_MAX_KEYS; ++j) {
    const bool on = j < nkeys;
    a.key[j] = on ? (const int64_t*)keys[j] : nullptr;
    a.step[j] = on ? steps[j] : 0;
    a.val[j] = on ? vals[j] : 0u;
  }
  a.nkeys = nkeys;
  a.op = op;
  a.stratified = stratified;
  a.xs = xs;
  a.ys = ys;
  a.seed = seed;
  a.n = n;
  a.out = out;
#ifdef __CUDACC__
  const unsigned blocks =
      (unsigned)((n + SAMPLER_THREADS - 1) / SAMPLER_THREADS);
  sampler_kernel<<<blocks, SAMPLER_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
#else
  (void)stream;
  for (int64_t i = 0; i < n; ++i) sampler_lane(a, i);
  return 0;
#endif
}
