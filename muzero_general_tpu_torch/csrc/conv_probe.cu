// The conv probe's two kernels for Hopper (sm_90a): y = relu(conv3x3(x, w) + b),
// a 3x3 SAME convolution with bias and ReLU on an NHWC activation that the
// caller pads once, x [B, H + 2, W + 2, C] -> y [B, H, W, C].
//
// conv_probe_9dot replaces the TPU kernel
// muzero_general_tpu/tools/conv_probe.py::_conv_kernel (launched by
// build_pallas): nine shifted [B*H*W, C] @ [C, C] products, tap by tap, on
// w9 [9, C, C]. conv_probe_im2col replaces
// muzero_general_tpu/tools/conv_probe.py::_conv_kernel_im2col (launched by
// build_pallas_im2col): one [tile, 9C] @ [9C, C] product over a patch tile
// gathered in shared memory, on w_flat [9C, C] (the same numbers as w9, rows
// tap * C + ci). Both take bfloat16 or float32 operands, accumulate in
// float32, add the bias [1, C] and apply the ReLU in float32, and store once
// in the input dtype (rounding to nearest even). Their plain PyTorch
// versions are muzero_general_tpu_torch/tools/conv_probe.py conv_9dot_plain
// and conv_im2col_plain; the comparison is a tolerance check (the sums run
// in another order than a PyTorch matmul's).
//
// What bounds them on this card: operations. At the probe's [64, 11, 11,
// 128] a conv is 2 * 7,744 * 1,152 * 128 = 2.284 GFLOP against 5.05 MB of
// bytes in bfloat16: 2.31 us at the dense bfloat16 tensor-core peak (989
// TFLOP/s) against 1.51 us at 3.35 TB/s. In float32 (no tensor cores at full
// float32 precision) the 67 TFLOP/s peak makes it 34 us.
//
// Design. The TPU kernels run the whole batch (or a `blocks` grid of batch
// slices) in one program with everything in VMEM; here a block of 4 warps
// owns a tile of BM output pixels by BN output channels, and nothing carries
// over between blocks. bfloat16 runs on the tensor cores through WMMA
// fragments (16 x 16 x 16, float32 accumulators), float32 as scalar FMAs of
// a 8 x 16 thread grid. The 9-dot kernel stages, per tap, the shifted pixel
// rows [BM, C] and the tap's weights [C, BN] in shared memory. The im2col
// kernel gathers the tile's whole patch matrix [BM, 9C] in shared memory once
// and streams the weights [9C, BN] from global memory (they stay in L2). A
// pixel row is 16-byte words; rows beyond B*H*W are zero. The accumulators go
// through shared memory to one epilogue (bias, ReLU, cast, store), which can
// write into the interior of a padded [B, H + 2, W + 2, C] output, so
// chained convolutions need no separate pad. wgmma, TMA and a pipeline of
// stages are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps
constexpr int kMaxSmem = 227 * 1024;

struct Geometry {
  int B, H, W, C;  // output pixels B x H x W, C channels in and out
  int opad;        // the output is [B, H + 2 opad, W + 2 opad, C], written inside
  __host__ __device__ int P() const { return B * H * W; }
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16(v); }

// Shared-memory leading dimensions: bfloat16 rows padded by 16 elements keep
// every WMMA fragment 32-byte aligned; float32 A rows padded by one word
// spread the scalar loop's column reads over the banks.
template <typename T>
__host__ __device__ constexpr int lda_of(int K) { return std::is_same<T, bf16>::value ? K + 16 : K + 1; }
template <typename T>
__host__ __device__ constexpr int ldb_of(int BN) { return std::is_same<T, bf16>::value ? BN + 16 : BN; }
__host__ __device__ constexpr int ldc_of(int BN) { return BN + 4; }

// One 16-byte word into shared memory: a vector store where the row is
// 16-byte aligned (bfloat16 rows), else element by element.
template <typename T>
__device__ __forceinline__ void store_word(T* dst, uint4 v) {
  if constexpr (std::is_same<T, bf16>::value) {
    *reinterpret_cast<uint4*>(dst) = v;
  } else {
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int k = 0; k < int(16 / sizeof(T)); ++k) dst[k] = e[k];
  }
}

// Input pixel (i + di, j + dj) of output pixel p, as a pointer to its C channels.
template <typename T>
__device__ __forceinline__ const T* input_row(const T* xp, const Geometry& g, int p, int di,
                                              int dj) {
  const int hw = g.H * g.W;
  const int b = p / hw, rem = p - b * hw, i = rem / g.W, j = rem - i * g.W;
  return xp + ((size_t)(b * (g.H + 2) + i + di) * (g.W + 2) + j + dj) * g.C;
}

// Rows [0, BM) of As, columns [col0, col0 + C): the C channels of input
// pixel (i + di, j + dj) of output pixel p0 + row; zero past the last pixel.
template <typename T, int BM>
__device__ void load_pixels(T* As, int lda, int col0, const T* xp, const Geometry& g, int p0,
                            int di, int dj) {
  constexpr int kVec = 16 / sizeof(T);
  const int words = g.C / kVec;
  for (int w = threadIdx.x; w < BM * words; w += kThreads) {
    const int r = w / words, c = (w - r * words) * kVec;
    const int p = p0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (p < g.P()) v = *reinterpret_cast<const uint4*>(input_row(xp, g, p, di, dj) + c);
    store_word(As + r * lda + col0 + c, v);
  }
}

// The accumulators of one thread for a BM x BN output tile.
template <typename T, int BM, int BN>
struct Tile;

// bfloat16: WMMA tiles of 16 x 16, dealt round-robin to the 4 warps.
template <int BM, int BN>
struct Tile<bf16, BM, BN> {
  static constexpr int kTiles = (BM / 16) * (BN / 16);
  static constexpr int kPerWarp = (kTiles + 3) / 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kPerWarp];

  __device__ void zero() {
#pragma unroll
    for (int f = 0; f < kPerWarp; ++f) wmma::fill_fragment(acc[f], 0.0f);
  }

  // acc += As[:, 0:K] @ Bp[0:K, 0:BN] (Bp in shared or global memory).
  __device__ void mma(const bf16* As, int lda, const bf16* Bp, int ldb, int K) {
    const int warp = threadIdx.x / 32;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
    for (int k = 0; k < K; k += 16) {
#pragma unroll
      for (int f = 0; f < kPerWarp; ++f) {
        const int t = warp + 4 * f;
        if (t >= kTiles) break;
        const int tr = t / (BN / 16), tc = t - tr * (BN / 16);
        wmma::load_matrix_sync(a, As + tr * 16 * lda + k, lda);
        wmma::load_matrix_sync(b, Bp + (size_t)k * ldb + tc * 16, ldb);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
  }

  __device__ void store(float* Cs, int ldc) {
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int f = 0; f < kPerWarp; ++f) {
      const int t = warp + 4 * f;
      if (t >= kTiles) break;
      const int tr = t / (BN / 16), tc = t - tr * (BN / 16);
      wmma::store_matrix_sync(Cs + tr * 16 * ldc + tc * 16, acc[f], ldc, wmma::mem_row_major);
    }
  }
};

// float32: the 128 threads as 8 rows x 16 columns, each BM/8 x BN/16 outputs.
template <int BM, int BN>
struct Tile<float, BM, BN> {
  static constexpr int kRows = BM / 8, kCols = BN / 16;
  float acc[kRows][kCols];

  __device__ void zero() {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
  }

  __device__ void mma(const float* As, int lda, const float* Bp, int ldb, int K) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    for (int k = 0; k < K; ++k) {
      float a[kRows], b[kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) a[r] = As[(ty * kRows + r) * lda + k];
#pragma unroll
      for (int c = 0; c < kCols; ++c) b[c] = Bp[(size_t)k * ldb + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }

  __device__ void store(float* Cs, int ldc) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) Cs[(ty * kRows + r) * ldc + tx + 16 * c] = acc[r][c];
  }
};

// bias, ReLU, cast and one store of the tile Cs [BM, BN] (float32).
template <typename T, int BM, int BN>
__device__ void epilogue(const float* Cs, const T* bias, T* out, const Geometry& g, int p0,
                         int co0) {
  const int ldc = ldc_of(BN), hw = g.H * g.W;
  const int Ho = g.H + 2 * g.opad, Wo = g.W + 2 * g.opad;
  for (int e = threadIdx.x; e < BM * BN; e += kThreads) {
    const int r = e / BN, c = e - r * BN, p = p0 + r;
    if (p >= g.P()) continue;
    const float v = fmaxf(Cs[r * ldc + c] + to_float(bias[co0 + c]), 0.0f);
    const int b = p / hw, rem = p - b * hw, i = rem / g.W, j = rem - i * g.W;
    out[((size_t)(b * Ho + i + g.opad) * Wo + j + g.opad) * g.C + co0 + c] = from_float<T>(v);
  }
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
    conv_9dot_kernel(const T* __restrict__ xp, const T* __restrict__ w9,
                     const T* __restrict__ bias, T* __restrict__ out, Geometry g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = g.C, lda = lda_of<T>(C), ldb = ldb_of<T>(BN);
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + BM * lda;
  const int p0 = blockIdx.x * BM, co0 = blockIdx.y * BN;
  constexpr int kVec = 16 / sizeof(T);
  Tile<T, BM, BN> tile;
  tile.zero();
  for (int tap = 0; tap < 9; ++tap) {
    load_pixels<T, BM>(As, lda, 0, xp, g, p0, tap / 3, tap % 3);
    const T* wt = w9 + (size_t)tap * C * C + co0;
    for (int w = threadIdx.x; w < C * (BN / kVec); w += kThreads) {
      const int ci = w / (BN / kVec), c = (w - ci * (BN / kVec)) * kVec;
      store_word(Bs + ci * ldb + c, *reinterpret_cast<const uint4*>(wt + (size_t)ci * C + c));
    }
    __syncthreads();
    tile.mma(As, lda, Bs, ldb, C);
    __syncthreads();
  }
  float* Cs = reinterpret_cast<float*>(smem);
  tile.store(Cs, ldc_of(BN));
  __syncthreads();
  epilogue<T, BM, BN>(Cs, bias, out, g, p0, co0);
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
    conv_im2col_kernel(const T* __restrict__ xp, const T* __restrict__ w_flat,
                       const T* __restrict__ bias, T* __restrict__ out, Geometry g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = g.C, lda = lda_of<T>(9 * C);
  T* As = reinterpret_cast<T*>(smem);
  const int p0 = blockIdx.x * BM, co0 = blockIdx.y * BN;
  for (int tap = 0; tap < 9; ++tap) load_pixels<T, BM>(As, lda, tap * C, xp, g, p0, tap / 3, tap % 3);
  __syncthreads();
  Tile<T, BM, BN> tile;
  tile.zero();
  tile.mma(As, lda, w_flat + co0, C, 9 * C);
  __syncthreads();
  float* Cs = reinterpret_cast<float*>(smem);
  tile.store(Cs, ldc_of(BN));
  __syncthreads();
  epilogue<T, BM, BN>(Cs, bias, out, g, p0, co0);
}

template <typename T, int BM, int BN>
size_t smem_9dot(int C) {
  const size_t ab = (size_t)BM * lda_of<T>(C) * sizeof(T) + (size_t)C * ldb_of<T>(BN) * sizeof(T);
  const size_t c = (size_t)BM * ldc_of(BN) * sizeof(float);
  return ab > c ? ab : c;
}

template <typename T, int BM, int BN>
size_t smem_im2col(int C) {
  const size_t a = (size_t)BM * lda_of<T>(9 * C) * sizeof(T);
  const size_t c = (size_t)BM * ldc_of(BN) * sizeof(float);
  return a > c ? a : c;
}

template <typename T, int BN>
int run(bool im2col, const void* xp, const void* w, const void* bias, void* out,
        const Geometry& g, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xp);
  const T* wt = static_cast<const T*>(w);
  const T* b = static_cast<const T*>(bias);
  T* y = static_cast<T*>(out);
  const dim3 block(kThreads);
  if (!im2col) {
    constexpr int BM = 64;
    const size_t smem = smem_9dot<T, BM, BN>(g.C);
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    auto kernel = conv_9dot_kernel<T, BM, BN>;
    if (smem > 48 * 1024) {
      cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            (int)smem);
      if (rc != cudaSuccess) return (int)rc;
    }
    kernel<<<dim3((g.P() + BM - 1) / BM, g.C / BN), block, smem, stream>>>(x, wt, b, y, g);
  } else {
    // A patch row is 9C wide: fewer pixels a tile than the 9-dot kernel.
    constexpr int BM = std::is_same<T, bf16>::value ? 32 : 16;
    const size_t smem = smem_im2col<T, BM, BN>(g.C);
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    auto kernel = conv_im2col_kernel<T, BM, BN>;
    if (smem > 48 * 1024) {
      cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            (int)smem);
      if (rc != cudaSuccess) return (int)rc;
    }
    kernel<<<dim3((g.P() + BM - 1) / BM, g.C / BN), block, smem, stream>>>(x, wt, b, y, g);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(bool im2col, const void* xp, const void* w, const void* bias, void* out,
             const Geometry& g, cudaStream_t stream) {
  if (g.C % 64 == 0) return run<T, 64>(im2col, xp, w, bias, out, g, stream);
  if (g.C % 32 == 0) return run<T, 32>(im2col, xp, w, bias, out, g, stream);
  return run<T, 16>(im2col, xp, w, bias, out, g, stream);
}

int conv(bool im2col, const void* xp, const void* w, const void* bias, void* out, int B, int H,
         int W, int C, int out_pad, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 16 != 0 || (out_pad != 0 && out_pad != 1))
    return (int)cudaErrorInvalidValue;
  const Geometry g{B, H, W, C, out_pad};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<bf16>(im2col, xp, w, bias, out, g, s)
                 : dispatch<float>(im2col, xp, w, bias, out, g, s);
}

}  // namespace

extern "C" const char* conv_probe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// y = relu(conv3x3(xp) + b) by nine shifted products. xp [B, H + 2, W + 2, C],
// w9 [9, C, C], b [1, C], all bfloat16 (is_bf16) or float32, contiguous, on
// the device; out [B, H + 2 out_pad, W + 2 out_pad, C], written inside its
// border of out_pad. C must be a multiple of 16. Returns a cudaError_t.
extern "C" int conv_probe_9dot(const void* xp, const void* w9, const void* b, void* out, int B,
                               int H, int W, int C, int out_pad, int is_bf16, void* stream) {
  return conv(false, xp, w9, b, out, B, H, W, C, out_pad, is_bf16, stream);
}

// The same by one im2col product on w_flat [9C, C].
extern "C" int conv_probe_im2col(const void* xp, const void* w_flat, const void* b, void* out,
                                 int B, int H, int W, int C, int out_pad, int is_bf16,
                                 void* stream) {
  return conv(true, xp, w_flat, b, out, B, H, W, C, out_pad, is_bf16, stream);
}
