// The folded ResNet's float32 3x3 convolution for Hopper (sm_90a), with its
// epilogue fused in: y = relu(conv3x3(x, w) + b [+ skip]), stride 1, pad 1,
// NCHW, x [N, Cin, H, W] -> y [N, Cout, H, W], skip (optional) [N, Cout, H, W].
//
// It replaces no TPU kernel: the JAX package leaves its convolutions to XLA.
// It was added because cuDNN runs these float32 convs (connect4's 3 x 64 on
// 6 x 7, at 1,024-2,048 leaves) as FFTs, five launches a conv plus the bias,
// skip and ReLU as separate elementwise kernels, at ~24% of the card's float32
// peak. Its plain PyTorch version is ops/conv3x3.py conv3x3_plain (F.conv2d with
// the bias, the skip add, ReLU); the comparison is a tolerance check against a
// float64 conv (the sums run in another order than cuDNN's).
//
// What bounds it. One conv at [2,048, 64, 6, 7] is 2 * 86,016 * 576 * 64 =
// 6.34 GFLOP: 94.7 us at the 67 TFLOP/s float32 peak (FMAs on the CUDA cores:
// TF32 tensor cores would lose the float32 precision the search is held to),
// against ~33 MB of input, skip and output, 10 us at 3.35 TB/s. So operations.
// Below that, the feed of the FMA pipes from shared memory and the issue slots
// the loads take from the FMAs.
//
// Design: an implicit GEMM (M = N H W pixels, N = Cout, K = 9 Cin), no im2col
// buffer and no pad op.
// - A thread owns one output pixel position of 8 samples x 8 output channels
//   (64 float32 accumulators). Its A operand, the 8 samples' input value at
//   one tap and channel, is two 16-byte shared-memory words, because the block
//   stages its activations sample-innermost, [channel][row][col][8 samples]:
//   the tap's shift moves whole 32-byte cells, so every load stays aligned.
//   Its B operand, 8 output channels of one (channel, tap), is two more (the
//   channels 4g..4g+3 and CT/2 + 4g.., so a warp's B words are contiguous). So
//   a tap costs 4 shared loads for 64 FMAs; a warp's 32 threads cover 8
//   positions x 4 channel groups, so its A loads are 8 distinct words and
//   its B loads broadcast.
// - A block's work item is 8 samples x R rows x all columns x CT = 32
//   output channels: R x W x CT / 8 threads, at most 384. connect4:
//   6 x 7 x 4 = 168 threads, two blocks an SM (167 registers a thread);
//   64-channel tiles, one block an SM, were as fast at 1,024-2,048 samples
//   and 1.35x slower at 512 on an H100.
//   Its K loop runs over chunks of 8 input channels; each chunk's staged
//   rows (R + 2 with the halo, each W + 2 wide) and its weight slice
//   [8][9][CT] come through a cp.async double buffer, the next chunk loading
//   while this one computes. The zero halo is shared memory that no copy
//   writes (cleared once), plus rows above or below the image and samples
//   past N, which the copy fills with zeros. Any Cin is taken: the last chunk
//   runs only the channels that are left.
// - The weights stream by chunk rather than staying resident: a chunk's
//   slice is ~4 16-byte copies a thread against ~4,600 FMAs, and streaming
//   lets one design take every shape (gomoku's 128 x 128 weights are 590 KB).
//   The host packs them once, per fold, as [Cin][9][Cout].
// - The grid is persistent: each block walks work items (the sample groups,
//   row tiles and channel tiles), and the chunk pipeline runs on across
//   items, so the next item's first chunk loads under this one's epilogue.
// - Epilogue from the registers: the bias, the skip, then ReLU, in float32,
//   stored straight to NCHW (a warp's stores are 4 runs of 8 floats). The
//   skip tile comes into shared memory by cp.async with the item's last
//   chunk: read from global memory in the epilogue, the loads' latency cost
//   15-40 us a conv at connect4's batches on an H100, up to a quarter of it.
// Arithmetic is float32 FMA with float32 accumulation throughout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSamples = 8;        // samples a work item (and a thread's A word pair)
constexpr int kChunk = 8;          // input channels a stage (fewer where Cin is)
constexpr int kMaxThreads = 384;   // a block's threads at most (R x W x CT / 8)
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use (227 KB)
constexpr int CT = 32;             // output channels a work item; a thread owns 8 of them

struct Shape {
  int N, Cin, Cout, H, W;
  int R;                                     // output rows a work item
  int row_tiles, chan_tiles, groups, items;  // items = groups x row_tiles x chan_tiles
  int CK, chunks;                            // input channels a stage, ceil(Cin / CK)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, or 4 zero bytes where !valid (src-size 0).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kMaxThreads, 1)
    conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, const float* __restrict__ skip,
                   float* __restrict__ y, Shape s) {
  constexpr int G = CT / 8;  // channel groups of 8
  extern __shared__ __align__(16) float smem[];
  const int Wp = s.W + 2, Rp = s.R + 2;
  const int plane = Rp * Wp * kSamples;  // floats of one channel's staged rows
  const int act_floats = s.CK * plane, wt_floats = s.CK * 9 * CT, RW = s.R * s.W;
  float* const act0 = smem;
  float* const wt0 = smem + 2 * act_floats;
  float* const skip_tile = wt0 + 2 * wt_floats;  // [8 samples][CT][R x W], the item's skip
  const int tid = threadIdx.x, nthreads = blockDim.x;
  for (int i = tid; i < 2 * (act_floats + wt_floats); i += nthreads) smem[i] = 0.0f;
  __syncthreads();

  const int g = tid % G, u = tid / G;  // channel group; position in the tile
  const int prow = u / s.W, pcol = u - prow * s.W;
  const int my_items =
      s.items > (int)blockIdx.x ? (s.items - (int)blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int stages = my_items * s.chunks;
  const size_t HW = (size_t)s.H * s.W;

  // Stage st = (this block's item st / chunks, chunk st % chunks) into buffer buf.
  auto load = [&](int st, int buf) {
    const int k = st / s.chunks, q = st - k * s.chunks;
    int it = blockIdx.x + k * gridDim.x;
    const int ct = it % s.chan_tiles;
    it /= s.chan_tiles;
    const int rt = it % s.row_tiles, grp = it / s.row_tiles;
    const int c0 = q * s.CK, kc = min(s.CK, s.Cin - c0);
    const int n0 = grp * kSamples, r0 = rt * s.R;
    float* a = act0 + buf * act_floats;
    // One task a staged row of one (channel, sample): W 4-byte copies. Rows
    // of a plane are neighbouring tasks, so a warp reads contiguous runs.
    const int tasks = kc * kSamples * Rp;
    for (int t = tid; t < tasks; t += nthreads) {
      const int rr = t % Rp, cs = t / Rp, smp = cs % kSamples, c = cs / kSamples;
      const int row = r0 - 1 + rr, n = n0 + smp;
      const bool valid = row >= 0 && row < s.H && n < s.N;
      const float* src = valid ? x + ((size_t)(n * s.Cin + c0 + c) * s.H + row) * s.W : x;
      const uint32_t dst = smem_u32(a + ((c * Rp + rr) * Wp + 1) * kSamples + smp);
      for (int col = 0; col < s.W; ++col)
        cp_async4(dst + col * kSamples * 4, valid ? src + col : x, valid);
    }
    float* b = wt0 + buf * wt_floats;
    const float* wsrc = w + (size_t)c0 * 9 * s.Cout + ct * CT;
    const int words = kc * 9 * (CT / 4);
    for (int e = tid; e < words; e += nthreads) {
      const int r = e / (CT / 4), j = e % (CT / 4);  // r = channel * 9 + tap
      cp_async16(smem_u32(b + r * CT + 4 * j), wsrc + (size_t)r * s.Cout + 4 * j);
    }
  };

  // The item's skip tile: one task a run of R x W floats of one (sample,
  // channel), issued with the item's last chunk so that it lands under the
  // chunk's FMAs and the epilogue reads shared memory.
  auto load_skip = [&](int ct, int rt, int grp) {
    const int rows = min(s.R, s.H - rt * s.R), run = rows * s.W;
    for (int t = tid; t < kSamples * CT; t += nthreads) {
      const int n = grp * kSamples + t / CT, co = ct * CT + t % CT;
      if (n >= s.N) continue;
      const float* src = skip + ((size_t)n * s.Cout + co) * HW + (size_t)rt * s.R * s.W;
      const uint32_t dst = smem_u32(skip_tile + t * RW);
      for (int e = 0; e < run; ++e) cp_async4(dst + 4 * e, src + e, true);
    }
  };

  float acc[kSamples][8];
#pragma unroll
  for (int i = 0; i < kSamples; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  if (stages > 0) load(0, 0);
  cp_async_commit();
  int k = 0, q = 0;  // stage st's item (of this block) and chunk
  for (int st = 0; st < stages; ++st) {
    const int buf = st & 1;
    cp_async_wait_all();
    __syncthreads();  // stage st landed for all; stage st - 1's buffer is free
    if (st + 1 < stages) load(st + 1, buf ^ 1);
    int it = blockIdx.x + k * gridDim.x;  // this stage's item
    const int ct = it % s.chan_tiles;
    it /= s.chan_tiles;
    const int rt = it % s.row_tiles, grp = it / s.row_tiles;
    const bool last = q + 1 == s.chunks;
    if (last && skip != nullptr) load_skip(ct, rt, grp);  // the last epilogue is done
    cp_async_commit();

    const int kc = min(s.CK, s.Cin - q * s.CK);
    const float* a = act0 + buf * act_floats + (prow * Wp + pcol) * kSamples;
    const float* b = wt0 + buf * wt_floats + 4 * g;
    for (int c = 0; c < kc; ++c, a += plane, b += 9 * CT) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* arow = a + dy * Wp * kSamples;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 a0 = *reinterpret_cast<const float4*>(arow + dx * kSamples);
          const float4 a1 = *reinterpret_cast<const float4*>(arow + dx * kSamples + 4);
          const float4 b0 = *reinterpret_cast<const float4*>(b + (dy * 3 + dx) * CT);
          const float4 b1 = *reinterpret_cast<const float4*>(b + (dy * 3 + dx) * CT + CT / 2);
          const float av[kSamples] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < kSamples; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
    }

    if (!last) {
      ++q;
      continue;
    }
    // The item's last chunk: epilogue, then the next item.
    if (skip != nullptr) {
      cp_async_wait_all();
      __syncthreads();  // every thread's skip copies landed
    }
    const int row = rt * s.R + prow;
    if (row < s.H) {
      const size_t pos = (size_t)row * s.W + pcol;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int co = ct * CT + (j < 4 ? 4 * g + j : CT / 2 + 4 * g + j - 4);
        const float bj = bias[co];
#pragma unroll
        for (int i = 0; i < kSamples; ++i) {
          const int n = grp * kSamples + i;
          if (n >= s.N) continue;
          const size_t idx = ((size_t)n * s.Cout + co) * HW + pos;
          float v = acc[i][j] + bj;
          if (skip != nullptr) v += skip_tile[(i * CT + co - ct * CT) * RW + u];
          y[idx] = v < 0.0f ? 0.0f : v;  // ReLU; a NaN stays NaN, as in torch.relu
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kSamples; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    q = 0;
    ++k;
  }
  cp_async_wait_all();
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!count[dev]) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev] > 0 ? count[dev] : 132;
}

// The launch plan of a shape: the most rows a work item (at most kMaxThreads
// threads) whose double buffer and skip tile fit shared memory (the tile is
// kept whether or not the call adds a skip, so that one plan serves both).
// False where the shape has none: Cout not a multiple of CT, or not one row
// fits.
bool plan(int N, int Cin, int Cout, int H, int W, Shape& s, size_t& smem, int& threads) {
  if (N <= 0 || Cin <= 0 || Cout <= 0 || H <= 0 || W <= 0 || Cout % CT != 0) return false;
  const int row_threads = W * (CT / 8);
  s.CK = Cin < kChunk ? Cin : kChunk;
  auto bytes = [&](int R) {  // the double buffer, then the skip tile
    return 2 * ((size_t)s.CK * (R + 2) * (W + 2) * kSamples + (size_t)s.CK * 9 * CT) * 4 +
           (size_t)kSamples * CT * R * W * 4;
  };
  int R = kMaxThreads / row_threads < H ? kMaxThreads / row_threads : H;
  while (R > 0 && bytes(R) > (size_t)kMaxSmem) --R;
  if (R == 0) return false;
  s.row_tiles = ceil_div(H, R);
  R = ceil_div(H, s.row_tiles);  // balanced row tiles
  s.N = N, s.Cin = Cin, s.Cout = Cout, s.H = H, s.W = W, s.R = R;
  s.chan_tiles = Cout / CT;
  s.groups = ceil_div(N, kSamples);
  s.items = s.groups * s.row_tiles * s.chan_tiles;
  s.chunks = ceil_div(Cin, s.CK);
  smem = bytes(R);
  threads = R * row_threads;
  return true;
}

// Resident blocks an SM for a block size and shared memory, cached (a net
// runs a few shapes; the query costs host time every launch).
int blocks_per_sm(int threads, size_t smem) {
  static int keys[16][2], values[16], used = 0;
  for (int i = 0; i < used; ++i)
    if (keys[i][0] == threads && keys[i][1] == (int)smem) return values[i];
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, conv3x3_kernel, threads, smem) !=
      cudaSuccess)
    return 0;
  if (used < 16) keys[used][0] = threads, keys[used][1] = (int)smem, values[used++] = blocks;
  return blocks;
}

}  // namespace

extern "C" const char* conv3x3_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// y = relu(conv3x3(x, w) + b [+ skip]), stride 1, pad 1. x [N, Cin, H, W],
// w [Cin, 9, Cout] (PyTorch's [Cout, Cin, 3, 3] packed: w[ci][3 dy + dx][co]),
// b [Cout], skip [N, Cout, H, W] or null, y [N, Cout, H, W]; all float32,
// contiguous, on the device, w 16-byte aligned. Returns a cudaError_t
// (cudaErrorInvalidValue for a shape with no launch plan).
extern "C" int conv3x3_forward(const void* x, const void* w, const void* b, const void* skip,
                               void* y, int N, int Cin, int Cout, int H, int W, void* stream) {
  Shape s;
  int threads = 0;
  size_t smem = 0;
  if (!plan(N, Cin, Cout, H, W, s, smem, threads)) return (int)cudaErrorInvalidValue;
  static bool ready = false;
  if (!ready) {
    cudaError_t rc = cudaFuncSetAttribute(
        conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (rc != cudaSuccess) return (int)rc;
    ready = true;
  }
  const int blocks = blocks_per_sm(threads, smem);
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  const int slots = blocks * sm_count();
  conv3x3_kernel<<<s.items < slots ? s.items : slots, threads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<const float*>(skip), static_cast<float*>(y), s);
  return (int)cudaGetLastError();
}
