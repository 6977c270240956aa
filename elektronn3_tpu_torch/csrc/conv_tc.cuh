// The implicit-GEMM geometry shared by K1's bf16 forward (conv_tc.cu)
// and K4's bf16 dgrad (dgrad_tc.cu): both run the (kd, 3, 3) 'same'
// conv as mma.sync products of a staged halo slab (A: voxels x 16
// channels a step) with 9 taps of packed weights (B: COB output columns
// a block), and differ in what they stage and in their epilogues.
#pragma once

#include "tc.cuh"

namespace {

using namespace e3;

constexpr int NT = 256;   // 8 warps
constexpr int KST = 2;    // K steps in flight (the cp.async ring)

template <int COB>
struct Cfg {
  static constexpr int WARPS_N = COB / 32;              // 1, 2, 4
  static constexpr int WARPS_M = 8 / WARPS_N;           // 8, 4, 2
  static constexpr int WM = COB == 32 ? 32 : 64;        // warp rows
  static constexpr int MI = WM / 16;                    // m16 tiles a warp
  static constexpr int M = WARPS_M * WM;                // 256, 256, 128
  static constexpr int BSTAGE = 9 * COB * 32;           // weight bytes
};

// A staged voxel's 16 channels occupy 32 of APITCH bytes: the 8 rows
// of an ldmatrix phase, 8 consecutive voxels from any start, then fall
// into 8 distinct 16-byte bank groups (48 = 3 x 16, and 3 is odd), and
// a tap's rows are a constant offset from tap (0, 0)'s.
constexpr int APITCH = 48;

// The 9 taps of one k16 step: B fragments of each tap from the weight
// slot (``bslot``: this lane's ldmatrix row of tap 0), A fragments at
// the tap's shifted voxels of the slab slot (``aslot``; ``arow`` the
// lane's row of each m16 tile at tap (0, 0); ``hw`` the slab width),
// accumulated into ``acc``.
template <int COB>
__device__ __forceinline__ void tap_mma9(float (*acc)[4][4],
                                         const uint32_t* arow,
                                         uint32_t aslot, uint32_t bslot,
                                         int hw) {
  using C = Cfg<COB>;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const uint32_t toff = aslot + ((tap / 3) * hw + tap % 3) * APITCH;
    uint32_t bf[4][2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t r[4];
      ldmatrix_x4(bslot + (tap * COB + p * 16) * 32, r);
      bf[2 * p][0] = r[0];
      bf[2 * p][1] = r[1];
      bf[2 * p + 1][0] = r[2];
      bf[2 * p + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi) {
      uint32_t af[4];
      ldmatrix_x4(arow[mi] + toff, af);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
        mma_bf16_16816(acc[mi][nj], af, bf[nj][0], bf[nj][1]);
    }
  }
}

}  // namespace
