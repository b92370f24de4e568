// CRC-32C operators shared by csrc/crc32c.cu and csrc/fused.cu. CRC-32C is
// linear over GF(2): appending n zero bytes to a register is a fixed linear
// map Z^n, held as eight nibble tables of 16 words (ops/crc32c.py
// op_tables builds them on the host).
#pragma once

#include <stdint.h>

#define OP_WORDS (8 * 16)  // one operator: eight nibble tables

// Z^n(v): nibble c of v indexes table c (16 words, so one lookup of a
// warp touches 16 distinct banks at most: no conflicts)
__device__ __forceinline__ uint32_t apply_op(const uint32_t* op, uint32_t v) {
    uint32_t o = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) o ^= op[16 * c + ((v >> (4 * c)) & 15u)];
    return o;
}
