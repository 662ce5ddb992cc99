// The kernels' random numbers: Philox4x32-10 and the two normal maps.
// Shared by K1 (fused_mc.cu) and K2 (sample_normals.cu); the plain
// PyTorch versions are gokalman_tpu_torch/ops/philox.py.
//
// Philox4x32-10 (Salmon et al., SC'11; the Random123 constants) is keyed
// by the 64-bit seed, its low word k0 and high word k1, and counts
// (member, draw, group, 0) with draw 0 for the initial state and t + 1
// for step t.  The kernels take the ten rounds' keys by value
// (`KeySchedule`, built on the host by `key_schedule`), so they are
// constant-bank operands.
#pragma once

#include <stdint.h>

namespace {

constexpr uint32_t PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;
constexpr int PHILOX_ROUNDS = 10;
// 1/sqrt(6 + (1 - 2^-16)/12): unit variance for popcount24 + dither.
constexpr float CLT_SCALE = 0.40544246941340006f;

// Philox4x32-10 round keys: k0 of round r at [r], k1 at [ROUNDS + r].
struct KeySchedule {
  uint32_t k[2 * PHILOX_ROUNDS];
};

// The round keys of a 64-bit seed (ops/philox.py:key_schedule): round 0
// takes the seed's two words, each round bumps them by (W0, W1).
inline KeySchedule key_schedule(uint64_t seed) {
  KeySchedule ks;
  uint32_t k0 = static_cast<uint32_t>(seed);
  uint32_t k1 = static_cast<uint32_t>(seed >> 32);
  for (int r = 0; r < PHILOX_ROUNDS; ++r) {
    ks.k[r] = k0;
    ks.k[PHILOX_ROUNDS + r] = k1;
    k0 += PHILOX_W0;
    k1 += PHILOX_W1;
  }
  return ks;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, const KeySchedule& ks) {
#pragma unroll
  for (int r = 0; r < PHILOX_ROUNDS; ++r) {
    const uint32_t lo0 = PHILOX_M0 * c.x, hi0 = __umulhi(PHILOX_M0, c.x);
    const uint32_t lo1 = PHILOX_M1 * c.z, hi1 = __umulhi(PHILOX_M1, c.z);
    c = make_uint4(hi1 ^ c.y ^ ks.k[r], lo1,
                   hi0 ^ c.w ^ ks.k[PHILOX_ROUNDS + r], lo0);
  }
  return c;
}

// (cos 2 pi u, sin 2 pi u), u in [0, 1): pallas_mc.py:_sincos_turns.
__device__ __forceinline__ void sincos_turns(float u, float& c, float& s) {
  const float t4 = 4.0f * u;
  const float q = floorf(t4);
  const float x = t4 - q;
  const float x2 = x * x;
  const float sp = x * (1.5707963257f + x2 * (-0.6459638093f
                   + x2 * (0.0796899578f + x2 * (-0.0046740125f
                   + x2 * 0.0001515384f))));
  const float cp = 1.0f + x2 * (-1.2336986638f + x2 * (0.2536513764f
                   + x2 * (-0.0208101642f + x2 * 0.0008574517f)));
  const int qi = static_cast<int>(q);
  const bool swap = (qi & 1) == 1;
  const float c0 = swap ? sp : cp;
  const float s0 = swap ? cp : sp;
  c = (qi == 1 || qi == 2) ? -c0 : c0;
  s = (qi == 2 || qi == 3) ? -s0 : s0;
}

__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Both branches of one Box-Muller pair: pallas_mc.py:_normal_pair.  The
// square root is the hardware approximation: its argument, -2 ln u1
// with u1 in [2^-25, 1 - 2^-25], is never 0, a denormal or infinite, so
// the IEEE sqrtf slow-path call would be dead code.  The logarithm is
// `logf`, not `__logf`: the fast one's absolute error (~2^-21) becomes
// up to ~1e-3 in r where u1 is near 1.
__device__ __forceinline__ void box_muller(uint32_t b1, uint32_t b2,
                                           float& a, float& b) {
  const float u1 = static_cast<float>(b1 & 0xFFFFFFu) * 0x1p-24f + 0x1p-25f;
  const float u2 = static_cast<float>(b2 & 0xFFFFFFu) * 0x1p-24f;
  const float r = sqrt_approx(-2.0f * logf(u1));
  float c, s;
  sincos_turns(u2, c, s);
  a = r * c;
  b = r * s;
}

// Popcount-CLT normal from one word: pallas_mc.py:_normal_clt.
__device__ __forceinline__ float clt_normal(uint32_t bits) {
  const int pc = __popc((bits >> 8) & 0xFFFFFFu);
  const float dither =
      (static_cast<float>(bits & 0xFFu) + 0.5f) * (1.0f / 256.0f) - 0.5f;
  return (static_cast<float>(pc) - 12.0f + dither) * CLT_SCALE;
}

// COUNT normals of one member's draw index `draw` (ops/philox.py:normals).
template <int COUNT, bool FAST>
__device__ __forceinline__ void draw_normals(uint32_t member, uint32_t draw,
                                             const KeySchedule& ks,
                                             float (&out)[COUNT]) {
  constexpr int WORDS = FAST ? COUNT : 2 * ((COUNT + 1) / 2);
  constexpr int GROUPS = (WORDS + 3) / 4;
  uint32_t w[GROUPS * 4];
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const uint4 r = philox4x32_10(
        make_uint4(member, draw, static_cast<uint32_t>(g), 0u), ks);
    w[4 * g] = r.x;
    w[4 * g + 1] = r.y;
    w[4 * g + 2] = r.z;
    w[4 * g + 3] = r.w;
  }
  if constexpr (FAST) {
#pragma unroll
    for (int i = 0; i < COUNT; ++i) out[i] = clt_normal(w[i]);
  } else {
#pragma unroll
    for (int j = 0; j < (COUNT + 1) / 2; ++j) {
      float a, b;
      box_muller(w[2 * j], w[2 * j + 1], a, b);
      out[2 * j] = a;
      if (2 * j + 1 < COUNT) out[2 * j + 1] = b;
    }
  }
}

}  // namespace
