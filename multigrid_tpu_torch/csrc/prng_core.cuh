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
// logic test (tests/test_torch_prng.py): R1's grid-stride walk
// (draw_strided) and R2's per-env bodies (step_draws_env) included. Float
// arithmetic is written with round-to-nearest intrinsics on the card and
// compiled without contraction on the host, as XLA computes it, but for the
// one fused multiply-add XLA makes of a uniform's scale and shift.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#if defined(__CUDACC__)
#define MGT_PRNG_FN __host__ __device__ __forceinline__
#define MGT_PRNG_UNROLL _Pragma("unroll")
#else
#define MGT_PRNG_FN inline
#define MGT_PRNG_UNROLL
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
// The most agents whose step draws R2 unrolls in registers (step_draws_env<N>).
constexpr int kMaxUnrolledAgents = 8;
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
// of 0 (maxval <= minval) draws minval. Takes the split's two keys (a0, a1)
// and (b0, b1), which a draw computes once for its key (DrawKey).
MGT_PRNG_FN int32_t randint(uint32_t a0, uint32_t a1, uint32_t b0, uint32_t b1, uint64_t i,
                            uint32_t span, int32_t minval) {
  if (span == 0) span = 1;
  const uint32_t hi = bits(a0, a1, i), lo = bits(b0, b1, i);
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  const uint32_t off = ((hi % span) * mult + lo % span) % span;
  return static_cast<int32_t>(static_cast<uint32_t>(minval) + off);
}

// One env's step draws (ops/step.py::step_draws): order_key, rng' =
// split(rng); the agents' order, the stable argsort of uniform(order_key,
// (n,)); then the fresh episode's keys by ``mode``. Keys are (word 0, word 1).
// The generic body, for any n up to kMaxStepAgents: one hash after another,
// the mantissas in an array (a stack frame on the card). R2 takes it past
// kMaxUnrolledAgents agents.
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

// The same for N agents known at compile time (1..kMaxUnrolledAgents): the
// loops unroll, so the mantissas and ranks stay in registers, and the
// hashes form independent chains three deep: the key's split; the order's
// N hashes beside the reset key's first (fold_in(rng', 0) or
// fold_in(rng', 1)); the exact reset's split.
template <int N>
MGT_PRNG_FN void step_draws_unrolled(uint32_t k0, uint32_t k1, int mode, int32_t* order,
                                     uint32_t* rng_out, uint32_t* gen_out,
                                     uint32_t* fresh_out) {
  uint32_t o0, o1, r0, r1;
  pair(k0, k1, 0, o0, o1);
  pair(k0, k1, 1, r0, r1);
  uint32_t m[N];
  MGT_PRNG_UNROLL
  for (int j = 0; j < N; ++j) m[j] = N == 1 ? 0u : bits(o0, o1, static_cast<uint64_t>(j)) >> 9;
  uint32_t f0 = 0, f1 = 0;
  if (mode != kStepOnly) pair(r0, r1, mode == kStepExact ? 0 : 1, f0, f1);
  rng_out[0] = r0;
  rng_out[1] = r1;
  MGT_PRNG_UNROLL
  for (int j = 0; j < N; ++j) {
    int rank = 0;
    MGT_PRNG_UNROLL
    for (int l = 0; l < N; ++l) rank += l < j ? (m[l] <= m[j]) : (m[l] < m[j]);
    order[rank] = j;
  }
  if (mode == kStepExact) {
    pair(f0, f1, 0, gen_out[0], gen_out[1]);
    pair(f0, f1, 1, fresh_out[0], fresh_out[1]);
  } else if (mode == kStepPool) {
    fresh_out[0] = f0;
    fresh_out[1] = f1;
  }
}

// R2's per-env body: the unrolled one for N agents, the generic one (for
// n agents) where N is 0.
template <int N>
MGT_PRNG_FN void step_draws_env(uint32_t k0, uint32_t k1, int n, int mode, int32_t* order,
                                uint32_t* rng_out, uint32_t* gen_out, uint32_t* fresh_out) {
  if constexpr (N == 0) {
    step_draws(k0, k1, n, mode, order, rng_out, gen_out, fresh_out);
  } else {
    step_draws_unrolled<N>(k0, k1, mode, order, rng_out, gen_out, fresh_out);
  }
}

// x / d and x % d, in 32-bit arithmetic where both fit: a 64-bit division
// is a long software routine on the card, on every element's path.
MGT_PRNG_FN void divmod(uint64_t x, uint64_t d, uint64_t& q, uint64_t& r) {
  if (((x | d) >> 32) == 0) {
    const uint32_t q32 = static_cast<uint32_t>(x) / static_cast<uint32_t>(d);
    q = q32;
    r = static_cast<uint32_t>(x) - q32 * static_cast<uint32_t>(d);
  } else {
    q = x / d;
    r = x - q * d;
  }
}

// One batched draw (R1's arguments): each of num_keys keys draws ``count``
// elements at flat indices offset + [0, count), written as ``mode`` asks
// into ``out``; element t is key t / count at index offset + t % count.
// ``spans`` (randint) is indexed by the flat index modulo ``span_len``, a
// span for each position of the draw's last axis. With ``keys_out``, each
// key is split first: the draw is made from element 1 of split(key) and
// element 0 is written to keys_out (one key drawn from, one key carried,
// in one pass); a count of 0 then writes keys_out alone.
struct DrawArgs {
  const int64_t* keys;
  int64_t* keys_out;
  int64_t num_keys, count;
  uint64_t offset;
  int mode;
  const int64_t* spans;
  int span_len;
  int32_t minval;
  float fmin, fmax;
  void* out;
};

// What an element needs of its key: the key drawn from (the key, or
// element 1 of its split), element 0 of the split where the draw splits
// first (independent of element 1: one hash deep), and randint's split of
// the key drawn from.
struct DrawKey {
  uint32_t k0, k1;          // the key drawn from
  uint32_t c0, c1;          // element 0 of the split: the key carried on
  uint32_t a0, a1, b0, b1;  // randint: split(k0, k1)
};

MGT_PRNG_FN DrawKey draw_key(const DrawArgs& a, int64_t k) {
  const uint32_t p0 = static_cast<uint32_t>(a.keys[2 * k]);
  const uint32_t p1 = static_cast<uint32_t>(a.keys[2 * k + 1]);
  DrawKey d = {p0, p1, 0u, 0u, 0u, 0u, 0u, 0u};
  if (a.keys_out != nullptr) {
    pair(p0, p1, 0, d.c0, d.c1);
    pair(p0, p1, 1, d.k0, d.k1);
  }
  if (a.mode == kRandint) {
    pair(d.k0, d.k1, 0, d.a0, d.a1);
    pair(d.k0, d.k1, 1, d.b0, d.b1);
  }
  return d;
}

// Element t of the draw from its key's words ``d``, at flat index i (``span``
// randint's span there).
MGT_PRNG_FN void draw_at(const DrawArgs& a, const DrawKey& d, int64_t t, uint64_t i,
                         uint32_t span) {
  switch (a.mode) {
    case kPair: {
      uint32_t y0, y1;
      pair(d.k0, d.k1, i, y0, y1);
      static_cast<int64_t*>(a.out)[2 * t] = y0;
      static_cast<int64_t*>(a.out)[2 * t + 1] = y1;
      break;
    }
    case kBits:
      static_cast<int64_t*>(a.out)[t] = bits(d.k0, d.k1, i);
      break;
    case kUniform:
      static_cast<float*>(a.out)[t] = uniform(bits(d.k0, d.k1, i), a.fmin, a.fmax);
      break;
    case kGumbel:
      static_cast<float*>(a.out)[t] = gumbel(bits(d.k0, d.k1, i));
      break;
    case kRandint:
      static_cast<int32_t*>(a.out)[t] = randint(d.a0, d.a1, d.b0, d.b1, i, span, a.minval);
      break;
  }
}

// The elements first, first + stride, ... of the draw: R1's grid-stride
// loop for one thread (first = its global index, stride = the grid's
// threads; one element a thread at the path's sizes). Each element's key
// words are its own: a cache of the last key's words, for threads that
// walk several elements of one key, timed slower on the card. With
// keys_out, element 0 of each key also writes its carried key.
MGT_PRNG_FN void draw_strided(const DrawArgs& a, int64_t first, int64_t stride) {
  const int64_t slots = a.count > 0 ? a.count : 1;
  const int64_t total = a.num_keys * slots;
  for (int64_t t = first; t < total; t += stride) {
    uint64_t k, j;
    divmod(static_cast<uint64_t>(t), static_cast<uint64_t>(slots), k, j);
    const uint64_t i = a.offset + j;
    // randint's span is read first, so that no store below holds the load
    // back behind the hashes.
    uint32_t span = 0;
    if (a.mode == kRandint && a.count > 0) {
      uint64_t q, pos = 0;
      if (a.span_len > 1) divmod(i, static_cast<uint64_t>(a.span_len), q, pos);
      span = static_cast<uint32_t>(a.spans[pos]);
    }
    const DrawKey d = draw_key(a, static_cast<int64_t>(k));
    if (a.keys_out != nullptr && j == 0) {
      a.keys_out[2 * k] = d.c0;
      a.keys_out[2 * k + 1] = d.c1;
    }
    if (a.count > 0) draw_at(a, d, t, i, span);
  }
}

}  // namespace mgt_prng
