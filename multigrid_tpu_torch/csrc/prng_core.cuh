// threefry2x32-20 and the draws the port makes from it, per element.
//
// The counterpart of jax._src.prng (threefry2x32, split, fold_in,
// random_bits with jax_threefry_partitionable on, as JAX 0.9 has it) and of
// the jax.random functions the JAX package calls (uniform, randint, gumbel).
// A draw of shape S from a key hashes the key with each element's flat index
// i in S, counted as the two words (i >> 32, i & 0xFFFFFFFF); so any range
// of rows of a draw is computed alone, with the same bits as the whole draw.
//
// Every function is __host__ __device__ where nvcc compiles it and plain
// inline C++ otherwise, so a host compiler builds the same code for the
// logic test (tests/test_torch_prng.py). Float arithmetic is written with
// round-to-nearest intrinsics on the card and compiled without contraction
// on the host, as XLA computes it, but for the one fused multiply-add XLA
// makes of a uniform's scale and shift.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#if defined(__CUDACC__)
#define MGT_PRNG_FN __host__ __device__ __forceinline__
#else
#define MGT_PRNG_FN inline
#endif

namespace mgt_prng {

// What a draw writes for each element (the wrapper's ``mode``).
enum Mode : int {
  kPair = 0,     // both words: split and fold_in (int64 pairs)
  kBits = 1,     // bits1 ^ bits2: random_bits (int64 holding uint32)
  kUniform = 2,  // uniform float32 in [minval, maxval)
  kGumbel = 3,   // -log(-log(uniform(tiny, 1))): gumbel, mode "low"
  kRandint = 4,  // randint: two draws from split(key), combined mod the span
};

// What the step draws make beside the order and the carried key.
enum StepMode : int {
  kStepOnly = 0,   // nothing more (MultiGridEnv.step)
  kStepExact = 1,  // split(fold_in(rng', 0)): the exact reset's gen_key, rng
  kStepPool = 2,   // fold_in(rng', 1): the pool's fresh rng
};

constexpr int kMaxStepAgents = 64;
constexpr uint32_t kFloatOne = 0x3F800000u;  // 1.0f
constexpr float kTiny = 1.17549435e-38f;     // float32's smallest normal

MGT_PRNG_FN uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

MGT_PRNG_FN void rounds(uint32_t& x0, uint32_t& x1, int a, int b, int c, int d) {
  x0 += x1; x1 = rotl(x1, a); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, b); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, c); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, d); x1 ^= x0;
}

// threefry2x32 with 20 rounds (prng.py::_threefry2x32_lowering): the key
// (k0, k1) hashes the count (x0, x1) into (x0, x1).
MGT_PRNG_FN void threefry(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k1; x1 += k2 + 1u;
  rounds(x0, x1, 17, 29, 16, 24); x0 += k2; x1 += k0 + 2u;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k0; x1 += k1 + 3u;
  rounds(x0, x1, 17, 29, 16, 24); x0 += k1; x1 += k2 + 4u;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k2; x1 += k0 + 5u;
}

// Both words of the key's hash of flat index i: element i of split(key, S),
// or fold_in(key, i).
MGT_PRNG_FN void pair(uint32_t k0, uint32_t k1, uint64_t i, uint32_t& y0, uint32_t& y1) {
  y0 = static_cast<uint32_t>(i >> 32);
  y1 = static_cast<uint32_t>(i);
  threefry(k0, k1, y0, y1);
}

// Element i of random_bits(key, 32, S).
MGT_PRNG_FN uint32_t bits(uint32_t k0, uint32_t k1, uint64_t i) {
  uint32_t y0, y1;
  pair(k0, k1, i, y0, y1);
  return y0 ^ y1;
}

MGT_PRNG_FN float as_float(uint32_t u) {
#if defined(__CUDA_ARCH__)
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
#endif
}

MGT_PRNG_FN float add_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

MGT_PRNG_FN float fma_rn(float a, float b, float c) {
#if defined(__CUDA_ARCH__)
  return __fmaf_rn(a, b, c);
#else
  return fmaf(a, b, c);
#endif
}

// uniform(key, minval, maxval) from its bits (random.py::_uniform): the top
// 23 bits as the mantissa of a float in [1, 2), less 1, scaled and shifted
// in one fused multiply-add (XLA fuses ``floats * (maxval - minval) +
// minval``), then at least minval.
MGT_PRNG_FN float uniform(uint32_t b, float minval, float maxval) {
  const float f = add_rn(as_float((b >> 9) | kFloatOne), -1.0f);
  const float x = fma_rn(f, add_rn(maxval, -minval), minval);
  return x > minval ? x : minval;
}

// Standard Gumbel noise from its bits (random.py::_gumbel, mode "low").
MGT_PRNG_FN float gumbel(uint32_t b) {
  return -logf(-logf(uniform(b, kTiny, 1.0f)));
}

// randint(key, minval, minval + span) at flat index i
// (random.py::_randint for 32-bit integers): k1, k2 = split(key), then the
// bits of both at i, combined modulo the span in uint32 arithmetic. A span
// of 0 (maxval <= minval) draws minval.
MGT_PRNG_FN int32_t randint(uint32_t k0, uint32_t k1, uint64_t i, uint32_t span,
                            int32_t minval) {
  if (span == 0) span = 1;
  uint32_t a0, a1, b0, b1;
  pair(k0, k1, 0, a0, a1);
  pair(k0, k1, 1, b0, b1);
  const uint32_t hi = bits(a0, a1, i), lo = bits(b0, b1, i);
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  const uint32_t off = ((hi % span) * mult + lo % span) % span;
  return static_cast<int32_t>(static_cast<uint32_t>(minval) + off);
}

// One env's step draws (ops/step.py::step_draws): order_key, rng' =
// split(rng); the agents' order, the stable argsort of uniform(order_key,
// (n,)); then the fresh episode's keys by ``mode``. Keys are (word 0, word 1).
MGT_PRNG_FN void step_draws(uint32_t k0, uint32_t k1, int n, int mode, int32_t* order,
                            uint32_t* rng_out, uint32_t* gen_out, uint32_t* fresh_out) {
  uint32_t o0, o1, r0, r1;
  pair(k0, k1, 0, o0, o1);
  pair(k0, k1, 1, r0, r1);
  rng_out[0] = r0;
  rng_out[1] = r1;
  if (n == 1) {
    order[0] = 0;
  } else {
    // Uniform floats order as their mantissas: rank each agent by the
    // mantissas below its own, ties by index (a stable sort).
    uint32_t m[kMaxStepAgents];
    for (int j = 0; j < n; ++j) m[j] = bits(o0, o1, static_cast<uint64_t>(j)) >> 9;
    for (int j = 0; j < n; ++j) {
      int rank = 0;
      for (int l = 0; l < n; ++l) rank += (m[l] < m[j]) || (m[l] == m[j] && l < j);
      order[rank] = j;
    }
  }
  if (mode == kStepExact) {
    uint32_t f0, f1;
    pair(r0, r1, 0, f0, f1);
    pair(f0, f1, 0, gen_out[0], gen_out[1]);
    pair(f0, f1, 1, fresh_out[0], fresh_out[1]);
  } else if (mode == kStepPool) {
    pair(r0, r1, 1, fresh_out[0], fresh_out[1]);
  }
}

// Element t of a batched draw: key t / count at flat index offset + t %
// count, written as ``mode`` asks. ``spans`` (randint) is indexed by the
// flat index modulo ``span_len``, a span for each position of the draw's
// last axis.
MGT_PRNG_FN void draw_element(const int64_t* keys, int64_t t, int64_t count, uint64_t offset,
                              int mode, const int64_t* spans, int span_len, int32_t minval,
                              float fmin, float fmax, void* out) {
  const int64_t k = t / count;
  const uint64_t i = offset + static_cast<uint64_t>(t - k * count);
  const uint32_t k0 = static_cast<uint32_t>(keys[2 * k]);
  const uint32_t k1 = static_cast<uint32_t>(keys[2 * k + 1]);
  switch (mode) {
    case kPair: {
      uint32_t y0, y1;
      pair(k0, k1, i, y0, y1);
      static_cast<int64_t*>(out)[2 * t] = y0;
      static_cast<int64_t*>(out)[2 * t + 1] = y1;
      break;
    }
    case kBits:
      static_cast<int64_t*>(out)[t] = bits(k0, k1, i);
      break;
    case kUniform:
      static_cast<float*>(out)[t] = uniform(bits(k0, k1, i), fmin, fmax);
      break;
    case kGumbel:
      static_cast<float*>(out)[t] = gumbel(bits(k0, k1, i));
      break;
    case kRandint:
      static_cast<int32_t*>(out)[t] = randint(
          k0, k1, i, static_cast<uint32_t>(spans[i % static_cast<uint64_t>(span_len)]), minval);
      break;
  }
}

}  // namespace mgt_prng
