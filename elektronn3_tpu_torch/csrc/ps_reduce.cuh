// The per-sample mode's statistics (group and instance norm), summed
// in an order that is the same on every run and for every batch size.
//
// In that mode K1 (conv_tc.cu, conv_bnact.cuh), row 3 (conv1_fwd.cu) and
// K3 (upconv_tc.cu, upconv_bnact.cu) add no float atomics across blocks:
// every block sums its own voxels in a fixed order (its threads', then
// its warps' in turn) and writes that partial row, (2, C): the sums,
// then the sums of squares, of the channels it covers, into slot p of
// its sample in ``part`` (n, P, 2 C), where the P slots of a sample
// depend on the sample's shape alone (a block never covers two samples).
// ps_reduce then sums each sample's P rows in a fixed order into ``out``
// (n, 2, C). Float atomics would add the blocks in the order they
// finish, and a group norm carries the last bits of its statistics into
// every voxel it normalizes: the forward's run-to-run differences would
// grow through the levels to about the bf16 rounding of the output.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace e3 {

// Floats of the workspace of ps_reduce for n samples of P partial rows
// of w floats: the rows themselves, then the first reduction's chunks.
int64_t ps_workspace_floats(int n, int64_t p, int w);

// out[s, :] = the sum over r of part[s, r, :] (w floats a row) for s < n,
// in chunks of a fixed size and a fixed order, then over the chunks in
// turn; ``part`` is the workspace's start (ps_workspace_floats), whose
// tail the chunks use, and is overwritten.
cudaError_t ps_reduce(float* part, int n, int64_t p, int w, float* out,
                      cudaStream_t stream);

}  // namespace e3
