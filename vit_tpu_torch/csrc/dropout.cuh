// The attention kernels' dropout mask (K1, K2, K6, K7/K8): the counter hash
// of vit_tpu/kernels/attention.py:_dropout_mask (:48-73), so that a backward
// regenerates its forward's mask exactly and the plain versions
// (kernels/attention.py:dropout_mask) draw the same one.
//
// Per (batch, head) stream hid = b·H + h + offset, over global logical
// coordinates (query row r, key column c, stride the logical S), in uint32:
//   x = r·S + c;  x ^= seed·0x9E3779B9;  x += hid·0x85EBCA6B;
//   x ^= x >> 16; x *= 0x85EBCA6B; x ^= x >> 13; x *= 0xC2B2AE35; x ^= x >> 16;
//   keep where x >= threshold, and scale the kept probability by `scale`.
// The threshold uint32(int(rate · 0xFFFFFFFF)) and the scale
// float32(1 / (1 - rate)) come from the host, formed there as the JAX package
// forms them, never from a float on the device. The seed is read from a (2,)
// int32 device vector [seed, offset], as the TPU kernels read seed_ref, so a
// caller can draw it on the device without a host synchronisation.
//
// Cost: about 13 integer operations per score element on the CUDA cores
// (an IMAD for the counter, the seed and stream terms, three xor-shifts, two
// IMULs, the compare and the select), computed again wherever a pass needs
// the mask: once in a forward, three times in a backward.

#pragma once

#include <stdint.h>

namespace vit {

// A kernel's dropout arguments; `seed` null means no dropout.
struct Dropout {
  const int* seed;     // (2,) int32 on the device: [seed, stream offset]
  uint32_t threshold;  // keep where hash >= threshold
  float scale;         // the kept probability's factor, 1 / (1 - rate)
};

// One (batch, head) stream's constant terms.
struct DropoutStream {
  uint32_t seed_term, hid_term, threshold;
  float scale;
};

__device__ __forceinline__ DropoutStream dropout_stream(const Dropout& d,
                                                        int bh) {
  const uint32_t seed = static_cast<uint32_t>(d.seed[0]);
  const uint32_t hid =
      static_cast<uint32_t>(bh) + static_cast<uint32_t>(d.seed[1]);
  return {seed * 0x9E3779B9u, hid * 0x85EBCA6Bu, d.threshold, d.scale};
}

__device__ __forceinline__ uint32_t dropout_hash(const DropoutStream& st,
                                                 uint32_t row, uint32_t col,
                                                 uint32_t stride) {
  uint32_t x = row * stride + col;
  x ^= st.seed_term;
  x += st.hid_term;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The mask value D at (row, col): `scale` where kept, 0 where dropped.
__device__ __forceinline__ float dropout_keep(const DropoutStream& st, int row,
                                              int col, int stride) {
  return dropout_hash(st, static_cast<uint32_t>(row),
                      static_cast<uint32_t>(col),
                      static_cast<uint32_t>(stride)) >= st.threshold
             ? st.scale
             : 0.0f;
}

// D at (row, col), or 1 where the key padding or the causal mask has
// already made p zero: no hash is spent there.
__device__ __forceinline__ float dropout_at(const DropoutStream& st, int row,
                                            int col, int S, int causal) {
  return (col >= S || (causal && col > row)) ? 1.0f
                                             : dropout_keep(st, row, col, S);
}

}  // namespace vit
