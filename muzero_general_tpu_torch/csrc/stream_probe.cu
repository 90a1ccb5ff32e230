// The stream probe's kernel for Hopper (sm_90a): a per-lane pointer chase
// through a float32 slab [B, N, S, A], the bare primitive under the gomoku
// stream descent (csrc/mcts_stream.cu): each level fetches one row per lane
// whose index the previous level's row gave.
//
// stream_probe_chase replaces the TPU kernel
// muzero_general_tpu/tools/stream_probe.py::_kernel (launched by build): for
// L levels (read on the device, as the TPU kernel reads levels_ref), lane b
// fetches row slab[b, cur_b] (S * A floats), adds the row's sum to its
// float32 accumulator and takes the next row index from row[0, 0],
// truncated to int (clamped into [0, N), where the TPU kernel would read out
// of bounds). The chain starts at row b % 7. Output acc [B, 1] float32. Its
// plain PyTorch version is muzero_general_tpu_torch/tools/stream_probe.py
// pointer_chase_plain; the sums run in another order, so the comparison is
// a tolerance check.
//
// What bounds it on this card: bytes, B * L * S * A * 4 (64 lanes x 64
// levels x 4 KB: 16.8 MB, 5.0 us at 3.35 TB/s). Its real limit is latency:
// every level's row address depends on the row before, so each level costs
// at least one device-memory round trip, however little it moves.
//
// Design. The TPU kernel issues all B lanes' row DMAs from one core and
// ships the next indices back to SMEM each level. Here each lane is a block
// of 256 threads that owns its chain: each thread loads 16-byte words of the
// row (one word each at S * A = 1,024), the block sums them (warp shuffles,
// then one value per warp through shared memory), and thread 0 broadcasts
// the next index through shared memory. The B chains run side by side on
// the SMs, so the lanes' latencies overlap as the TPU kernel's DMAs do.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    pointer_chase_kernel(const int* __restrict__ levels, const float* __restrict__ slab,
                         float* __restrict__ acc_out, int N, int row_floats) {
  __shared__ float warp_sums[kThreads / 32];
  __shared__ int next;
  const int b = blockIdx.x, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float* chain = slab + (size_t)b * N * row_floats;
  const int L = *levels;
  const int words = row_floats / 4;
  int cur = min(b % 7, N - 1);
  float acc = 0.0f;
  for (int t = 0; t < L; ++t) {
    const float4* row = reinterpret_cast<const float4*>(chain + (size_t)cur * row_floats);
    float s = 0.0f;
    for (int i = threadIdx.x; i < words; i += kThreads) {
      const float4 v = row[i];
      s += (v.x + v.y) + (v.z + v.w);
      if (i == 0) next = min(max((int)v.x, 0), N - 1);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) warp_sums[warp] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.0f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
      acc += total;
    }
    cur = next;
    __syncthreads();  // warp_sums and next are rewritten by the next level
  }
  if (threadIdx.x == 0) acc_out[b] = acc;
}

}  // namespace

extern "C" const char* stream_probe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// acc[b] = the sum of the L rows of lane b's chain (L = *levels, on the
// device). slab [B, N, row_floats] float32, 16-byte aligned, row_floats a
// multiple of 4; acc [B] float32. Returns a cudaError_t.
extern "C" int stream_probe_chase(const int* levels, const float* slab, float* acc, int B, int N,
                                  int row_floats, void* stream) {
  if (B <= 0 || N <= 0 || row_floats <= 0 || row_floats % 4 != 0) return (int)cudaErrorInvalidValue;
  pointer_chase_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(levels, slab, acc, N,
                                                                               row_floats);
  return (int)cudaGetLastError();
}
