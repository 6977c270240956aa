// ps_reduce (ps_reduce.cuh): the per-sample statistics' deterministic
// sum over the blocks' partial rows. A pass sums chunks of PS_CHUNK rows
// of every sample, each float of a row by PS_LANES threads in a fixed
// interleave and then in lane order; passes repeat on the chunk sums
// until one row a sample is left.
// What bounds it: the partial rows' bytes (2 C floats a block of the
// kernel that wrote them, under 2% of that kernel's output).
#include "ps_reduce.cuh"

namespace {

constexpr int PS_CHUNK = 256;   // rows of a chunk
constexpr int PS_COLS = 32;     // floats of a row a block sums
constexpr int PS_LANES = 8;     // row lanes a block: rows r, r + 8, ...

// Chunk blockIdx.x of sample blockIdx.y, floats PS_COLS * blockIdx.z ..:
// row lane ry sums rows ry, ry + PS_LANES, ... of the chunk in order (a
// warp reads 32 consecutive floats of a row), then lane 0 adds the
// PS_LANES lane sums in order.
__global__ void __launch_bounds__(PS_COLS * PS_LANES) ps_sum_chunks(
    const float* __restrict__ in, int64_t rows, int w,
    float* __restrict__ out, int64_t chunks) {
  __shared__ float s_sum[PS_LANES][PS_COLS];
  const int cx = threadIdx.x % PS_COLS;
  const int ry = threadIdx.x / PS_COLS;
  const int c = blockIdx.z * PS_COLS + cx;
  const int64_t s = blockIdx.y;
  const int64_t r0 = (int64_t)blockIdx.x * PS_CHUNK;
  const int64_t r1 = r0 + PS_CHUNK < rows ? r0 + PS_CHUNK : rows;
  float acc = 0.0f;
  if (c < w) {
    const float* src = in + (s * rows + r0 + ry) * w + c;
#pragma unroll 8
    for (int64_t r = r0 + ry; r < r1; r += PS_LANES, src += PS_LANES * w)
      acc += *src;
  }
  s_sum[ry][cx] = acc;
  __syncthreads();
  if (ry == 0 && c < w) {
    float t = s_sum[0][cx];
#pragma unroll
    for (int k = 1; k < PS_LANES; ++k) t += s_sum[k][cx];
    out[(s * chunks + blockIdx.x) * w + c] = t;
  }
}

}  // namespace

namespace e3 {

int64_t ps_workspace_floats(int n, int64_t p, int w) {
  return (int64_t)n * w * (p + (p + PS_CHUNK - 1) / PS_CHUNK);
}

}  // namespace e3

// ps_workspace_floats for the wrappers, which allocate the workspace.
extern "C" int64_t e3_ps_workspace_floats(int n, int64_t p, int w) {
  return e3::ps_workspace_floats(n, p, w);
}

namespace e3 {

cudaError_t ps_reduce(float* part, int n, int64_t p, int w, float* out,
                      cudaStream_t stream) {
  if (n > 65535 || n < 1 || p < 1) return cudaErrorInvalidValue;
  // Ping-pong between the rows and the tail: each pass's chunks are
  // written where the pass before did not read.
  float* src = part;
  float* tail = part + (int64_t)n * p * w;
  while (true) {
    const int64_t chunks = (p + PS_CHUNK - 1) / PS_CHUNK;
    float* dst = chunks == 1 ? out : (src == part ? tail : part);
    const dim3 grid((unsigned)chunks, n, (w + PS_COLS - 1) / PS_COLS);
    ps_sum_chunks<<<grid, PS_COLS * PS_LANES, 0, stream>>>(src, p, w, dst,
                                                           chunks);
    if (chunks == 1) break;
    src = dst;
    p = chunks;
  }
  return cudaGetLastError();
}

}  // namespace e3
