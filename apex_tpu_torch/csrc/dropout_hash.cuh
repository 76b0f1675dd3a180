// The attention-dropout keep mask of the flash kernels: the JAX kernels'
// counter hash (`_fmix32` and `_keep_from_positions`,
// apex_tpu/ops/flash_attention.py:140-169), bit for bit. An element (batch
// bi, head hi, query position q, key position k; positions global, so the
// mask does not depend on any block size) is kept where
//
//   fmix32(q * 0x9E3779B1 ^ k * 0x85EBCA77 ^ base) >= threshold,
//   base = fmix32(seed ^ bi * 0x9E3779B1 ^ hi * 0xB5297A4D),
//
// in uint32 arithmetic, with threshold = min(rate * 2^32, 2^32 - 1) computed
// on the host; a kept element is scaled by 1 / (1 - rate). No state: the
// forward (flash_fwd_sm90.cu) and the single-pass backward
// (flash_bwd_sm90.cu) regenerate the same mask and never store it. A kernel
// hoists the terms of its fixed positions (`base` with its own row's or
// key's term) and hashes one xor and one fmix32 an element.
//
// Also compiled by a host compiler (no CUDA), for the CPU test that holds
// it bitwise against the plain version.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define APEX_DROPOUT_FN __host__ __device__ __forceinline__
#else
#define APEX_DROPOUT_FN inline
#endif

namespace dropout {

// the murmur3 finalizer (public constants)
APEX_DROPOUT_FN uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// the hash's term of (seed, batch, head)
APEX_DROPOUT_FN uint32_t base(uint32_t seed, uint32_t bi, uint32_t hi) {
  return fmix32(seed ^ (bi * 0x9E3779B1u) ^ (hi * 0xB5297A4Du));
}

// a query position's and a key position's terms
APEX_DROPOUT_FN uint32_t q_term(uint32_t q) { return q * 0x9E3779B1u; }
APEX_DROPOUT_FN uint32_t k_term(uint32_t k) { return k * 0x85EBCA77u; }

// whether the element whose three terms xor to `h` is kept
APEX_DROPOUT_FN bool keep(uint32_t h, uint32_t threshold) {
  return fmix32(h) >= threshold;
}

}  // namespace dropout
