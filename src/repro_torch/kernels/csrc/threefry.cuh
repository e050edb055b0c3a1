// JAX's threefry PRNG as device code, bit for bit with jax.random in its
// partitionable mode (the default since JAX 0.5): the draws of the
// reference's stochastic forwarding policies (repro/fleetsim/core.py,
// _route_next, random and power_of_two).  The plain version is
// repro_torch/fleetsim/rng.py; the functions here are its, one for one.
//
// Integer work only until uniform()'s bits-to-float step: threefry-2x32
// is 20 rounds of add, rotate and xor on two 32-bit words with a key
// injection after every four, about 130 operations; a forward's draws
// (two fold_ins and a uniform, or for power_of_two a split and two
// uniforms more) are three to six of them, a few hundred integer
// operations on one thread.
#pragma once

#include <cstdint>

namespace threefry {

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// One group of four rounds, then the key injection after it.
template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void group(uint32_t& x0, uint32_t& x1,
                                      uint32_t a, uint32_t b, uint32_t i) {
  x0 += x1; x1 = rotl(x1, R0) ^ x0;
  x0 += x1; x1 = rotl(x1, R1) ^ x0;
  x0 += x1; x1 = rotl(x1, R2) ^ x0;
  x0 += x1; x1 = rotl(x1, R3) ^ x0;
  x0 += a;
  x1 += b + i;
}

// threefry2x32(key, (x0, x1)): both output words in x0, x1.
__device__ __forceinline__ void hash(Key k, uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k.k0 ^ k.k1 ^ 0x1BD11BDAu;
  x0 += k.k0;
  x1 += k.k1;
  group<13, 15, 26, 6>(x0, x1, k.k1, k2, 1);
  group<17, 29, 16, 24>(x0, x1, k2, k.k0, 2);
  group<13, 15, 26, 6>(x0, x1, k.k0, k.k1, 3);
  group<17, 29, 16, 24>(x0, x1, k.k1, k2, 4);
  group<13, 15, 26, 6>(x0, x1, k2, k.k0, 5);
}

// jax.random.PRNGKey(seed) for a 32-bit seed
__device__ __forceinline__ Key prng_key(uint32_t seed) { return {0u, seed}; }

// jax.random.fold_in(key, data), data as uint32
__device__ __forceinline__ Key fold_in(Key k, uint32_t data) {
  uint32_t x0 = 0u, x1 = data;
  hash(k, x0, x1);
  return {x0, x1};
}

// jax.random.split(key): key i of two is threefry2x32(key, (0, i))
__device__ __forceinline__ void split(Key k, Key* a, Key* b) {
  uint32_t x0 = 0u, x1 = 0u;
  hash(k, x0, x1);
  *a = {x0, x1};
  x0 = 0u;
  x1 = 1u;
  hash(k, x0, x1);
  *b = {x0, x1};
}

// jax.random.uniform(key) on [0, 1): the top 23 of the 32 bits x0 ^ x1
// of threefry2x32(key, (0, 0)) under the exponent of 1.0, minus 1.0, then
// the reference's scale (one fused multiply-add, as XLA contracts it: an
// identity on [0, 1)) and clamp
__device__ __forceinline__ float uniform(Key k) {
  uint32_t x0 = 0u, x1 = 0u;
  hash(k, x0, x1);
  const float one = __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u);
  return fmaxf(0.0f, __fmaf_rn(__fsub_rn(one, 1.0f), 1.0f, 0.0f));
}

// min(int32(u * n), max(n - 1, 0)): one f32 product, truncated
__device__ __forceinline__ int scaled_index(float u, int n) {
  return min(static_cast<int>(__fmul_rn(u, static_cast<float>(n))),
             max(n - 1, 0));
}

}  // namespace threefry
