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
// every level's row address depends on the row before, so a level costs at
// least one dependent round trip to the L2 (or to device memory when the
// L2 is cold) of the 4-byte pointer, however little it moves. No design of
// a chained fetch comes near half the bytes bound at these sizes: 64 lanes
// x 64 levels of that latency floor alone take several times 5 us.
//
// Design. The chain needs only one word of each row, the pointer; the
// row's sum feeds nothing that follows. So the sum is taken off the chain.
// Each lane is a block of two warps sharing a ring of R stages in shared
// memory, each stage with a "full" and an "empty" mbarrier:
// - the chaser (warp 0, lane 0) owns the chain. Per level it loads the
//   pointer row[cur][0] with a relaxed gpu-scope load (issued first, and
//   not merged or hoisted by the compiler), then issues one bulk
//   asynchronous copy (cp.async.bulk, the TMA's plain 1-D form) of row cur
//   into the next stage, completing on that stage's full barrier, and only
//   then converts and clamps the pointer and goes on. It waits on a
//   stage's empty barrier before it reuses the stage;
// - the consumer (warp 1) sums each stage as it lands (each lane up to
//   eight 16-byte words loaded together), releases it, and adds its share
//   of the level's sum to its share of acc, level by level; the 32 shares
//   are added by shuffles once, after the last level (the float32 sums run
//   in another order than the plain version's, as before).
// A level's critical path is one dependent 4-byte round trip plus the
// conversion; the row copies and the sums of earlier levels overlap it.
// (Measured on the card: with a shuffle reduction per level, or a serial
// load-add loop, the consumer took 330-460 cycles a level and held the
// chaser back through the ring.)
// A row wider than a stage (kStageCap bytes) goes as several bulk copies,
// one stage each. R = min(8, kRingShare / stage bytes) stages.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 64;             // warp 0: the chaser; warp 1: the consumer
constexpr int kMaxStages = 8;
constexpr int kStageCap = 16 * 1024;     // bytes a stage holds at most
constexpr int kRingShare = 64 * 1024;    // bytes of shared memory the ring may take
constexpr int kUnroll = 8;               // 16-byte words a consumer lane loads at once

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// The chaser's arrival, announcing `bytes` of copies that will complete on `bar`.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// `bytes` (a multiple of 16, both ends 16-byte aligned) global -> shared,
// completing on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// The chain's pointer: a relaxed gpu-scope load (served by the L2), which
// the compiler neither hoists nor merges with the row copy.
__device__ __forceinline__ float load_pointer(const float* p) {
  float v;
  asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];\n" : "=f"(v) : "l"(p) : "memory");
  return v;
}

struct Ring {
  int stages;       // R
  int chunks;       // copies (stages) a row takes
  int stage_bytes;  // min(row bytes, kStageCap): every copy's but a row's last
};

Ring plan_ring(int row_floats) {
  Ring r;
  const int row_bytes = row_floats * 4;
  r.stage_bytes = row_bytes < kStageCap ? row_bytes : kStageCap;
  r.chunks = (row_bytes + r.stage_bytes - 1) / r.stage_bytes;
  r.stages = kRingShare / r.stage_bytes < kMaxStages ? kRingShare / r.stage_bytes : kMaxStages;
  return r;
}

__global__ void __launch_bounds__(kThreads)
    pointer_chase_kernel(const int* __restrict__ levels, const float* __restrict__ slab,
                         float* __restrict__ acc_out, int N, int row_floats, Ring ring) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxStages];  // full[R], then empty[R]
  const int b = blockIdx.x, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * kMaxStages;
  const uint32_t ring0 = smem_u32(ring_smem);
  const int R = ring.stages, C = ring.chunks;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the chaser's arrival, plus the copy's bytes
      mbar_init(empty0 + 8 * s, 1);  // the consumer's lane 0, once the stage is summed
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int L = *levels;
  const float* chain = slab + (size_t)b * N * row_floats;
  const int row_bytes = row_floats * 4;

  if (warp == 0) {
    if (lane != 0) return;
    // ---- the chaser ------------------------------------------------------
    int cur = min(b % 7, N - 1);
    int s = 0;
    uint32_t phase = 0;  // parity of the ring's current pass
    bool first_pass = true;
    for (int t = 0; t < L; ++t) {
      const float* row = chain + (size_t)cur * row_floats;
      const float pointer = load_pointer(row);
      for (int c = 0; c < C; ++c) {
        if (!first_pass) mbar_wait(empty0 + 8 * s, phase ^ 1);
        const int off = c * ring.stage_bytes;
        const uint32_t bytes = min(ring.stage_bytes, row_bytes - off);
        mbar_arrive_expect_tx(full0 + 8 * s, bytes);
        bulk_copy(ring0 + s * ring.stage_bytes, reinterpret_cast<const char*>(row) + off, bytes,
                  full0 + 8 * s);
        if (++s == R) {
          s = 0;
          phase ^= 1;
          first_pass = false;
        }
      }
      cur = min(max((int)pointer, 0), N - 1);
    }
    return;
  }

  // ---- the consumer: every stage summed as it lands -----------------------
  // Each lane adds its share of a level's row (up to kUnroll 16-byte words,
  // loaded together) to its share of acc, level by level; the shares are
  // added across the warp once, at the end, so no shuffle sits in a level.
  float part = 0.0f;
  int s = 0;
  uint32_t phase = 0;
  for (int t = 0; t < L; ++t) {
    float level = 0.0f;
    for (int c = 0; c < C; ++c) {
      const int words = min(ring.stage_bytes, row_bytes - c * ring.stage_bytes) / 16;
      mbar_wait(full0 + 8 * s, phase);
      const float4* stage = reinterpret_cast<const float4*>(ring_smem + s * ring.stage_bytes);
      for (int base = 0; base < words; base += 32 * kUnroll) {
        float4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = base + 32 * u + lane;
          v[u] = i < words ? stage[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) level += (v[u].x + v[u].y) + (v[u].z + v[u].w);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);  // the stage may be refilled
      if (++s == R) {
        s = 0;
        phase ^= 1;
      }
    }
    part += level;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  if (lane == 0) acc_out[b] = part;
}

// The chase's latency floor: one thread a lane follows the same chain
// through the pointer words alone (the same relaxed load, no row copies, no
// sums) and writes the row it ends on. No design of a chained fetch beats
// its time a level. A measurement, not a path: only
// tools/stream_probe_cost.py launches it, checks its rows against numpy and
// times it beside the chase.
__global__ void __launch_bounds__(32)
    pointer_floor_kernel(const int* __restrict__ levels, const float* __restrict__ slab,
                         int* __restrict__ cur_out, int N, int row_floats) {
  if (threadIdx.x != 0) return;
  const int b = blockIdx.x;
  const float* chain = slab + (size_t)b * N * row_floats;
  const int L = *levels;
  int cur = min(b % 7, N - 1);
  for (int t = 0; t < L; ++t) cur = min(max((int)load_pointer(chain + (size_t)cur * row_floats), 0), N - 1);
  cur_out[b] = cur;
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
  static bool smem_allowed = false;
  if (!smem_allowed) {
    cudaError_t rc = cudaFuncSetAttribute(pointer_chase_kernel,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, kRingShare);
    if (rc != cudaSuccess) return (int)rc;
    smem_allowed = true;
  }
  const Ring ring = plan_ring(row_floats);
  pointer_chase_kernel<<<B, kThreads, ring.stages * ring.stage_bytes,
                         static_cast<cudaStream_t>(stream)>>>(levels, slab, acc, N, row_floats,
                                                              ring);
  return (int)cudaGetLastError();
}

// cur[b] = the row lane b's chain reaches after L = *levels levels, by the
// pointer words alone (the chase's latency floor). Arguments as
// stream_probe_chase's; cur [B] int32. Returns a cudaError_t.
extern "C" int stream_probe_floor(const int* levels, const float* slab, int* cur, int B, int N,
                                  int row_floats, void* stream) {
  if (B <= 0 || N <= 0 || row_floats <= 0 || row_floats % 4 != 0) return (int)cudaErrorInvalidValue;
  pointer_floor_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(levels, slab, cur, N,
                                                                        row_floats);
  return (int)cudaGetLastError();
}
