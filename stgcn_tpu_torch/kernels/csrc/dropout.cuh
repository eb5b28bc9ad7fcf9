// Dropout keyed by element: the CUDA twin of stgcn_tpu_torch/kernels/dropout.py.
//
// An element is kept when bits(seed, site, index) >= threshold
// (threshold = round(p * 2^32)) and then scaled by 1 / (1 - p). bits is a
// counter-based hash built from MurmurHash3's fmix32; index is the logical
// element index in [B, T, C, V_true] order, never a tile or a padded lane,
// so a backward kernel regenerates the forward's mask under any tiling and
// the plain PyTorch version computes the same bits.
#pragma once

#include <cstdint>

namespace stgcn {

struct Drop {
  uint32_t seed;
  int site;
  uint32_t threshold;  // 0: the site is off (no mask is applied)
  float scale;         // 1 / (1 - p)
  int v_true;          // true vertex lanes of the dropped tensor
};

__host__ __device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

__host__ __device__ __forceinline__ uint32_t drop_key(uint32_t seed, int site) {
  return fmix32(seed ^ fmix32((uint32_t)site * 0x9E3779B9u + 0x7F4A7C15u));
}

__host__ __device__ __forceinline__ uint32_t drop_bits(uint32_t key, uint64_t index) {
  const uint32_t lo = (uint32_t)index, hi = (uint32_t)(index >> 32);
  return fmix32(fmix32(lo ^ key) ^ (hi * 0x85EBCA6Bu));
}

// The pre-scaled keep mask of element (row, v) of a cv tensor whose rows are
// the flattened (b, t, c) = row: 0 on padded lanes, scale where kept. Only
// for an active site (threshold > 0); an inactive one multiplies by nothing.
__device__ __forceinline__ float drop_mask(const Drop& d, uint32_t key, size_t row, int v) {
  if (v >= d.v_true) return 0.0f;
  const uint64_t index = (uint64_t)row * (uint64_t)d.v_true + (uint64_t)v;
  return drop_bits(key, index) >= d.threshold ? d.scale : 0.0f;
}

}  // namespace stgcn
