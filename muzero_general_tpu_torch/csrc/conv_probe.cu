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
// What bounds them on this card. At the probe's [64, 11, 11, 128] a conv is
// 2 * 7,744 * 1,152 * 128 = 2.284 GFLOP against 5.05 MB in bfloat16: 2.31 us
// at the dense bfloat16 tensor-core peak (989 TFLOP/s) against 1.51 us at
// 3.35 TB/s, so operations. In float32 (no tensor cores at full float32
// precision) the 67 TFLOP/s CUDA-core peak makes it 34 us. At connect4's
// 2,048 leaves [2048, 6, 7, 64] the bytes bound it (29.96 MB, 8.9 us). Below
// those, each block's feed from L2: an output tile of BM pixels needs all
// 9C x BN weights and its pixels once a tap (a 64 x 128 tile at C = 128
// reads 144 KB of pixels and 288 KB of weights), and the instructions that
// keep that feed going must stay off the critical path.
//
// Design.
// - bfloat16: one or two consumer warpgroups run wgmma.mma_async
//   m64nBNk16 (BN = 64 where C <= 64, else 128, as many BN-wide column tiles
//   as C needs), both operands read by descriptor from shared memory in the
//   128-byte-swizzled layout, the float32 accumulators in registers.
//   Channels are the K dimension, in 64-wide chunks (128-byte rows): a tile
//   runs 9 taps x ceil(C / 64) stages. One producer thread keeps a ring of
//   up to 12 stages in flight with TMA tensor copies (the swizzle and the
//   zero fill past C and past the input's edge done by the copy engine),
//   each stage announced to an mbarrier by its byte count, each slot
//   released by one arrival per consumer warp after wgmma.wait_group says
//   the products that read it are done. The ring's slots, phases and taps
//   advance by increments: a division per stage cost more than the products.
// - A tile's pixels are a box of the image grid (wb columns x hb rows x bb
//   images, at most 64 or 128), so that a tap's shifted pixels are one box
//   of the padded input at (c, j0 + dj, i0 + di, b0): one TMA copy. Tiles of
//   128 pixels (two consumer warpgroups) halve the weight bytes a pixel
//   costs; they are taken where they need no more waves than 64-pixel ones.
//   The grid is persistent: each block walks tiles, so the producer loads
//   the next tile while the consumers run the epilogue.
// - The two variants differ where the pixels live. 9-dot: a stage holds one
//   tap's pixel box and its [64, BN] weight slice, and both stream through
//   the ring. im2col: the block gathers its whole patch tile [BM, 9C] into
//   shared memory once (144 KB at C = 128, BM = 64), chunk by chunk in stage
//   order, and only the weight slices stream through the ring; where the
//   tile does not fit (C > 128) it holds as many chunks as fit and recycles
//   them in stage order. Where all 9C x BN weights fit beside the pixels
//   (C <= 64: 72 KB), they stay resident across the block's tiles and only
//   pixels stream.
// - float32 stays on the CUDA cores in full float32: 16 x 16 (or 8 x 16)
//   threads, each a 4 x 8 (4 x 4 where C <= 64) outer-product micro-tile,
//   32-channel A and B slices in a 3-stage cp.async ring (im2col: the patch
//   tile resident, BM = 32), every operand of the inner loop read from
//   shared memory.
// - Epilogue: bias, ReLU and the cast from the registers; bfloat16 tiles go
//   through shared memory so that every store to global memory is 16 bytes,
//   float32 threads store their 4-wide rows directly. The output may be the
//   interior of a padded [B, H + 2, W + 2, C] buffer, so chained convolutions
//   need no separate pad.

#include <cuda.h>  // CUtensorMap (the encoder is reached through the runtime)
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxSmem = 232448;    // dynamic shared memory a block may use (227 KB)
constexpr int kSmemPerSm = 233472;  // the SM's 228 KB, 1 KB of it reserved per block

struct Geometry {
  int B, H, W, C;  // output pixels B x H x W, C channels in and out
  int opad;        // the output is [B, H + 2 opad, W + 2 opad, C], written inside
  __host__ __device__ int P() const { return B * H * W; }
};

// A bfloat16 tile's pixels: a box of wb columns x hb rows x bb images of
// the output, nj x ni x nb boxes covering it.
struct Box {
  int wb, hb, bb, nj, ni, nb;
};

// How a launch walks its work: KC channel chunks a tap, NS = 9 KC stages a
// tile, a ring of S stages in flight; RA pixel slots and RB weight slots in
// shared memory (RA = S for 9-dot, the patch tile's NS chunks for im2col;
// RB = NS where the weights stay resident, else S). Global stage g of a
// block uses ring slot g % S, pixel slot g % RA and weight slot g % RB: with
// RA, RB >= S the slot's previous user, stage g - RA or g - RB, has been
// released before the producer may refill it.
struct Plan {
  int KC, NS, S, RA, RB;  // S: the ring's depth (bfloat16; float32: kStagesF)
  int num_m, tiles;       // pixel tiles, and tiles in all (times the column tiles)
  Box box;                // bfloat16 only
};

// Element offset in xp of input pixel (i, j) of output pixel p (tap 0, 0).
__device__ __forceinline__ long long pixel_offset(const Geometry& g, int p) {
  const int hw = g.H * g.W;
  const int b = p / hw, rem = p - b * hw, i = rem / g.W, j = rem - i * g.W;
  return ((long long)(b * (g.H + 2) + i) * (g.W + 2) + j) * g.C;
}

// Element offset in out of output pixel p.
__device__ __forceinline__ long long out_offset(const Geometry& g, int p) {
  const int hw = g.H * g.W;
  const int b = p / hw, rem = p - b * hw, i = rem / g.W, j = rem - i * g.W;
  const int Ho = g.H + 2 * g.opad, Wo = g.W + 2 * g.opad;
  return ((long long)(b * Ho + i + g.opad) * Wo + j + g.opad) * g.C;
}

// ---- PTX: asynchronous copies, mbarriers, wgmma ---------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where !valid (src-size 0).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

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
// The producer's arrival, announcing `bytes` of copies that will complete on `bar`.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// TMA: one box of a tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int kCount>
__device__ __forceinline__ void consumer_sync() {  // the consumer threads only
  asm volatile("bar.sync 1, %0;\n" ::"n"(kCount) : "memory");
}

// A shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d[0:BN/2] += A[64, 16] @ B[16, BN], float32 accumulators; A K-major and B
// N-major in shared memory (imm-trans-b = 1), both 128-byte swizzled.
__device__ __forceinline__ void wgmma_m64n64k16(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_k16(float* d, uint64_t desc_a, uint64_t desc_b) {
  if constexpr (BN == 128) {
    wgmma_m64n128k16(d, desc_a, desc_b);
  } else {
    wgmma_m64n64k16(d, desc_a, desc_b);
  }
}

// ---- bfloat16: wgmma fed by a TMA ring ----------------------------------------

constexpr int kMaxStages = 12;  // the ring's deepest (its barriers are allocated for this)
constexpr int kChunk = 64;      // channels a stage: one 128-byte row
constexpr int kSlotRows = 64;   // pixel rows a consumer warpgroup owns: one wgmma M

// NCW consumer warpgroups, each owning 64 of the tile's BM = 64 NCW pixel
// rows, and one producer warp after them.
template <int BN, int NCW>
struct Bf16Layout {
  static constexpr int kBM = kSlotRows * NCW;
  static constexpr int kConsumers = 128 * NCW;
  static constexpr int kThreads = kConsumers + 32;
  static constexpr int kSlotA = kBM * 128;        // a [BM, 64] pixel slice
  static constexpr int kSlotB = kChunk * BN * 2;  // a [64, BN] weight slice
  static constexpr int kLdo = BN + 8;             // staging row (elements), 16-byte padded
  // The epilogue's staging tile, then the tile's bias [BN] (float32) and
  // its rows' output pixels [BM] (int32, -1 where the row is no pixel).
  static constexpr int kStaging = kBM * kLdo * 2 + BN * 4 + kBM * 4;
  static size_t bytes(const Plan& pl) {
    return 1024 /* alignment slack */ + (size_t)pl.RA * kSlotA + (size_t)pl.RB * kSlotB +
           kStaging + 2 * kMaxStages * 8;
  }
};

// A block's position in its stage sequence: the ring slot and the parity of
// its round, the pixel slot and the weight slot (kept by increments: a
// division on this path costs more than the wgmma it feeds).
struct Ring {
  int slot = 0, phase = 0, a = 0, b = 0;
  __device__ __forceinline__ void advance(const Plan& pl) {
    if (++slot == pl.S) slot = 0, phase ^= 1;
    if (++a == pl.RA) a = 0;
    if (++b == pl.RB) b = 0;
  }
};

template <int BN, int NCW>
__device__ void conv_bf16(const CUtensorMap* xmap, const CUtensorMap* wmap,
                          const bf16* __restrict__ bias, bf16* __restrict__ out,
                          const Geometry& g, const Plan& pl) {
  using L = Bf16Layout<BN, NCW>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  unsigned char* smem = smem_raw + pad;
  const uint32_t a_base = raw + pad;
  const uint32_t b_base = a_base + pl.RA * L::kSlotA;
  bf16* staging = reinterpret_cast<bf16*>(smem + pl.RA * L::kSlotA + pl.RB * L::kSlotB);
  float* bias_s = reinterpret_cast<float*>(staging + L::kBM * L::kLdo);
  int* row_px = reinterpret_cast<int*>(bias_s + BN);
  const uint32_t full0 = smem_u32(smem + pl.RA * L::kSlotA + pl.RB * L::kSlotB + L::kStaging);
  const uint32_t empty0 = full0 + 8 * kMaxStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < pl.S; ++s) {
      mbar_init(full0 + 8 * s, 1);         // the producer's arrival, plus the copies' bytes
      mbar_init(empty0 + 8 * s, 4 * NCW);  // the consumers' warps, once their products are done
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const Box& box = pl.box;
  const int C = g.C;

  if (threadIdx.x >= L::kConsumers) {
    // Producer: one thread starts every copy of the ring.
    if (threadIdx.x != L::kConsumers) return;
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(xmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(wmap)) : "memory");
    const uint32_t box_bytes = (uint32_t)(box.wb * box.hb * box.bb) * 128;
    Ring ring;
    int loaded_n0 = -1;
    for (int t = blockIdx.x; t < pl.tiles; t += gridDim.x) {
      const int m = t % pl.num_m, n0 = (t / pl.num_m) * BN;
      const int j0 = (m % box.nj) * box.wb, i0 = (m / box.nj % box.ni) * box.hb,
                b0 = m / (box.nj * box.ni) * box.bb;
      // Resident weights are loaded once per column tile.
      const bool load_b = !(pl.RB == pl.NS && n0 == loaded_n0);
      loaded_n0 = n0;
      for (int tap = 0; tap < 9; ++tap) {
        for (int c = 0; c < C; c += kChunk, ring.advance(pl)) {
          mbar_wait(empty0 + 8 * ring.slot, ring.phase ^ 1);
          const uint32_t bar = full0 + 8 * ring.slot;
          mbar_arrive_expect_tx(bar, box_bytes + (load_b ? BN * 128 : 0));
          // The tap's shifted pixels: the box at (c, j0 + dj, i0 + di, b0) of
          // the padded input, zero past C (and past the input's edge).
          tma_load_4d(a_base + ring.a * L::kSlotA, xmap, bar, c, j0 + tap % 3, i0 + tap / 3, b0);
          if (load_b) {
            // Weight rows tap * C + c .. + 64, 64 columns a swizzle atom.
#pragma unroll
            for (int atom = 0; atom < BN / 64; ++atom)
              tma_load_3d(b_base + ring.b * L::kSlotB + atom * (kChunk * 128), wmap, bar,
                          n0 + 64 * atom, c, tap);
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns pixel rows [64 cw, 64 cw + 64) of the tile.
  const int cw = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  float acc[BN / 2];
  Ring ring;
  for (int t = blockIdx.x; t < pl.tiles; t += gridDim.x) {
    const int m = t % pl.num_m, n0 = (t / pl.num_m) * BN;
    const int j0 = (m % box.nj) * box.wb, i0 = (m / box.nj % box.ni) * box.hb,
              b0 = m / (box.nj * box.ni) * box.bb;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    // The tile's bias and output rows, for the epilogue, while its first
    // stages load. Row r is pixel (b0 + r / (wb hb), i0 + r / wb % hb, j0 + r % wb).
    consumer_sync<L::kConsumers>();  // the previous tile's epilogue is done with them
    for (int i = threadIdx.x; i < BN; i += L::kConsumers)
      bias_s[i] = n0 + i < C ? __bfloat162float(bias[n0 + i]) : 0.0f;
    for (int r = threadIdx.x; r < L::kBM; r += L::kConsumers) {
      const int j = j0 + r % box.wb, i = i0 + r / box.wb % box.hb, b = b0 + r / (box.wb * box.hb);
      row_px[r] = r < box.wb * box.hb * box.bb && j < g.W && i < g.H && b < g.B
                      ? (b * (g.H + 2 * g.opad) + i + g.opad) * (g.W + 2 * g.opad) + j + g.opad
                      : -1;
    }
    int prev = -1;  // the ring slot of the previous stage, released one stage late
    for (int s = 0; s < pl.NS; ++s, ring.advance(pl)) {
      mbar_wait(full0 + 8 * ring.slot, ring.phase);
      __syncwarp();  // wgmma's .aligned instructions need the warp converged
      const uint32_t a = a_base + ring.a * L::kSlotA + cw * (kSlotRows * 128);
      const uint32_t b = b_base + ring.b * L::kSlotB;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kChunk / 16; ++k) {
        // A: advance 16 channels = 32 bytes along the swizzled row; 8-row
        // groups 1024 bytes apart. B: 16 rows = 2048 bytes down; 8-row groups
        // 1024 bytes apart, 64-column atoms 8192 bytes apart.
        wgmma_k16<BN>(acc, smem_desc(a + 32 * k, 16, 1024),
                      smem_desc(b + 2048 * k, kChunk * 128, 1024));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release its slot
      if (prev >= 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
      prev = ring.slot;
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty0 + 8 * prev);

    // Epilogue: bias, ReLU, cast into the staging tile, then 16-byte stores.
    // Accumulator i of this thread: row warp * 16 + lane / 4 (+ 8 for i % 4
    // >= 2) of its warpgroup's 64, column (i / 4) * 8 + (lane % 4) * 2 + i % 2.
    consumer_sync<L::kConsumers>();  // bias_s and row_px are written
#pragma unroll
    for (int n8 = 0; n8 < BN / 8; ++n8) {
      const int col = n8 * 8 + (lane % 4) * 2;
      const float b0f = bias_s[col], b1f = bias_s[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = cw * kSlotRows + warp * 16 + lane / 4 + 8 * h;
        *reinterpret_cast<__nv_bfloat162*>(staging + r * L::kLdo + col) =
            __floats2bfloat162_rn(fmaxf(acc[n8 * 4 + 2 * h] + b0f, 0.0f),
                                  fmaxf(acc[n8 * 4 + 2 * h + 1] + b1f, 0.0f));
      }
    }
    consumer_sync<L::kConsumers>();
    constexpr int kWords = BN / 8;
#pragma unroll 4
    for (int e = threadIdx.x; e < L::kBM * kWords; e += L::kConsumers) {
      const int r = e / kWords, col = (e % kWords) * 8, px = row_px[r];
      if (px >= 0 && n0 + col < C)
        *reinterpret_cast<uint4*>(out + (size_t)px * C + n0 + col) =
            *reinterpret_cast<const uint4*>(staging + r * L::kLdo + col);
    }
  }
}

template <int BN, int NCW>
__global__ void __launch_bounds__(Bf16Layout<BN, NCW>::kThreads, 1)
    conv_9dot_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap w9map,
                          const bf16* __restrict__ bias, bf16* __restrict__ out, Geometry g,
                          Plan pl) {
  conv_bf16<BN, NCW>(&xmap, &w9map, bias, out, g, pl);
}

template <int BN, int NCW>
__global__ void __launch_bounds__(Bf16Layout<BN, NCW>::kThreads, 1)
    conv_im2col_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap wmap,
                            const bf16* __restrict__ bias, bf16* __restrict__ out, Geometry g,
                            Plan pl) {
  conv_bf16<BN, NCW>(&xmap, &wmap, bias, out, g, pl);
}

// ---- float32: register-blocked CUDA-core products over a cp.async ring ------

constexpr int kBK = 32;      // channels a stage: one 128-byte row of floats
constexpr int kStagesF = 3;  // the ring's depth

// A block of kThreads owns a BM x BN output tile: 16 threads across the
// columns (each 4, or 8 as two 4-wide groups 64 apart), kThreads / 16 down
// the rows (each BM / (kThreads / 16)). A slices [BM, 32] and B slices
// [32, BN] come through the ring; the im2col kernel's A slots hold the
// patch tile (RA = NS where it fits).
template <int BM, int BN, int kThreads, bool kIm2col>
__global__ void __launch_bounds__(kThreads)
    conv_f32_kernel(const float* __restrict__ xp, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out, Geometry g, Plan pl) {
  constexpr int TY = kThreads / 16, TM = BM / TY, TN = BN / 16, kGroups = TN / 4;
  constexpr int kWordsA = BM * kBK / 4 / kThreads, kWordsB = kBK * BN / 4 / kThreads;
  static_assert(TM == 4 && kWordsA >= 1 && kWordsB >= 1, "tile shape");
  extern __shared__ __align__(16) float smem_f[];
  const int RA = kIm2col ? pl.RA : kStagesF;
  float* As = smem_f;                  // RA slots of [BM, kBK]
  float* Bs = As + RA * BM * kBK;      // kStagesF slots of [kBK, BN]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, C = g.C;

  // This thread's copies: A words e = tid + kThreads * i (row e / 8, word e % 8),
  // B words e (row e / (BN / 4), word e % (BN / 4)).
  long long pix[kWordsA];
#pragma unroll
  for (int i = 0; i < kWordsA; ++i) {
    const int p = m0 + (tid + kThreads * i) / 8;
    pix[i] = p < g.P() ? pixel_offset(g, p) : -1;
  }
  // The next stage to load: its tap, first channel and slots (by increments).
  int ld_tap = 0, ld_c = 0, ld_a = 0, ld_b = 0;
  auto load = [&]() {
    const int tap = ld_tap, kc0 = ld_c;
    const int tap_off = ((tap / 3) * (g.W + 2) + tap % 3) * C;
    float* a = As + ld_a * BM * kBK;
    float* b = Bs + ld_b * kBK * BN;
    if ((ld_c += kBK) >= C) ld_c = 0, ++ld_tap;
    if (++ld_a == RA) ld_a = 0;
    if (++ld_b == kStagesF) ld_b = 0;
#pragma unroll
    for (int i = 0; i < kWordsA; ++i) {
      const int e = tid + kThreads * i, r = e / 8, c = kc0 + (e % 8) * 4;
      const bool valid = pix[i] >= 0 && c < C;
      cp_async16(smem_u32(a + r * kBK + (e % 8) * 4), valid ? xp + pix[i] + tap_off + c : xp,
                 valid);
    }
#pragma unroll
    for (int i = 0; i < kWordsB; ++i) {
      const int e = tid + kThreads * i, k = e / (BN / 4), col = (e % (BN / 4)) * 4;
      const int ci = kc0 + k, co = n0 + col;
      const bool valid = ci < C && co < C;
      cp_async16(smem_u32(b + k * BN + col), valid ? w + (size_t)(tap * C + ci) * C + co : w,
                 valid);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStagesF - 1; ++s) {
    if (s < pl.NS) load();
    cp_async_commit();
  }
  int use_a = 0, use_b = 0;  // stage s's slots
  for (int s = 0; s < pl.NS; ++s) {
    cp_async_wait<kStagesF - 2>();
    __syncthreads();  // stage s landed for all; stage s - 1's slots are free
    if (s + kStagesF - 1 < pl.NS) load();
    cp_async_commit();
    const float* a = As + use_a * BM * kBK + ty * TM * kBK;
    const float* b = Bs + use_b * kBK * BN + tx * 4;
    if (++use_a == RA) use_a = 0;
    if (++use_b == kStagesF) use_b = 0;
#pragma unroll
    for (int k0 = 0; k0 < kBK; k0 += 4) {
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = *reinterpret_cast<const float4*>(a + i * kBK + k0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[TN];
#pragma unroll
        for (int q = 0; q < kGroups; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(b + (k0 + kk) * BN + 64 * q);
          bv[4 * q] = v.x, bv[4 * q + 1] = v.y, bv[4 * q + 2] = v.z, bv[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float ai = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait_all();

  // Epilogue: bias, ReLU, one 16-byte store per row and column group.
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    const int co = n0 + tx * 4 + 64 * q;
    if (co >= C) continue;
    const float b0 = bias[co], b1 = bias[co + 1], b2 = bias[co + 2], b3 = bias[co + 3];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int p = m0 + ty * TM + i;
      if (p >= g.P()) continue;
      float4 v;
      v.x = fmaxf(acc[i][4 * q] + b0, 0.0f);
      v.y = fmaxf(acc[i][4 * q + 1] + b1, 0.0f);
      v.z = fmaxf(acc[i][4 * q + 2] + b2, 0.0f);
      v.w = fmaxf(acc[i][4 * q + 3] + b3, 0.0f);
      *reinterpret_cast<float4*>(out + out_offset(g, p) + co) = v;
    }
  }
}

// ---- launch -----------------------------------------------------------------

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Let `kernel` use up to kMaxSmem of dynamic shared memory (once per kernel).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  done = rc == cudaSuccess;
  return rc;
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!count[dev]) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev] > 0 ? count[dev] : 132;
}

// libcuda's tensor-map encoder, looked up through the CUDA runtime (so the
// build needs no -lcuda); null where it is missing.
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  return encode;
}

// A bfloat16 tensor map with a 128-byte-swizzled box (dims innermost first;
// the inner box is 64 elements = 128 bytes; out-of-bounds elements read 0).
bool encode_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Output tiles as boxes of the image grid: wb columns x hb rows x bb
// images, at most BM pixels, balanced along each dimension.
Box make_box(const Geometry& g, int BM) {
  Box x;
  x.wb = g.W < BM ? g.W : BM;
  x.nj = ceil_div(g.W, x.wb);
  x.wb = ceil_div(g.W, x.nj);
  x.hb = g.H < BM / x.wb ? g.H : BM / x.wb;
  x.ni = ceil_div(g.H, x.hb);
  x.hb = ceil_div(g.H, x.ni);
  x.bb = 1;
  if (x.ni == 1) x.bb = g.B < BM / (x.wb * x.hb) ? g.B : BM / (x.wb * x.hb);
  x.nb = ceil_div(g.B, x.bb);
  x.bb = ceil_div(g.B, x.nb);
  return x;
}

// The bfloat16 plan of BN x (64 NCW) tiles: the deepest ring that fits, the
// weights resident where they fit too. im2col first keeps its whole patch
// tile (RA = NS), or as many of its chunks as fit; 9-dot streams its pixels
// (RA = S). False if nothing fits.
template <int BN, int NCW>
bool plan_bf16(bool im2col, const Geometry& g, Plan& pl) {
  using L = Bf16Layout<BN, NCW>;
  pl.KC = ceil_div(g.C, kChunk);
  pl.NS = 9 * pl.KC;
  pl.box = make_box(g, L::kBM);
  pl.num_m = pl.box.nj * pl.box.ni * pl.box.nb;
  pl.tiles = pl.num_m * ceil_div(g.C, BN);
  for (int ra = im2col ? pl.NS : 0; ra >= (im2col ? 2 : 0); --ra) {
    for (int depth = kMaxStages; depth >= 2; --depth) {
      pl.S = im2col && depth > ra ? ra : depth;
      pl.RA = im2col ? ra : pl.S;
      for (int rb : {pl.NS, pl.S}) {
        pl.RB = rb;
        if (L::bytes(pl) <= (size_t)kMaxSmem) return true;
      }
    }
  }
  return false;
}

// Blocks a launch runs at once: one or two a SM, as shared memory allows.
template <int BN, int NCW>
int grid_slots(const Plan& pl) {
  const int per_sm = (int)(kSmemPerSm / (Bf16Layout<BN, NCW>::bytes(pl) + 1024));
  return sm_count() * (per_sm > 1 ? per_sm : 1);
}

template <int BN, int NCW>
int launch_bf16(bool im2col, const Plan& pl, const bf16* x, const bf16* w, const bf16* b, bf16* y,
                const Geometry& g, cudaStream_t stream) {
  using L = Bf16Layout<BN, NCW>;
  CUtensorMap xmap, wmap;
  const cuuint64_t C = g.C, row = 2 * C;
  const cuuint64_t xdims[4] = {C, (cuuint64_t)g.W + 2, (cuuint64_t)g.H + 2, (cuuint64_t)g.B};
  const cuuint64_t xstrides[3] = {row, row * (g.W + 2), row * (g.W + 2) * (g.H + 2)};
  const cuuint32_t xbox[4] = {kChunk, (cuuint32_t)pl.box.wb, (cuuint32_t)pl.box.hb,
                              (cuuint32_t)pl.box.bb};
  const cuuint64_t wdims[3] = {C, C, 9}, wstrides[2] = {row, row * C};
  const cuuint32_t wbox[3] = {64, kChunk, 1};
  if (!encode_map(&xmap, x, 4, xdims, xstrides, xbox) ||
      !encode_map(&wmap, w, 3, wdims, wstrides, wbox))
    return (int)cudaErrorInvalidValue;
  const size_t smem = L::bytes(pl);
  const int slots = grid_slots<BN, NCW>(pl);
  const int grid = pl.tiles < slots ? pl.tiles : slots;
  cudaError_t rc;
  if (im2col) {
    static bool ready = false;
    if ((rc = allow_smem(conv_im2col_bf16_kernel<BN, NCW>, ready)) != cudaSuccess) return (int)rc;
    conv_im2col_bf16_kernel<BN, NCW><<<grid, L::kThreads, smem, stream>>>(xmap, wmap, b, y, g, pl);
  } else {
    static bool ready = false;
    if ((rc = allow_smem(conv_9dot_bf16_kernel<BN, NCW>, ready)) != cudaSuccess) return (int)rc;
    conv_9dot_bf16_kernel<BN, NCW><<<grid, L::kThreads, smem, stream>>>(xmap, wmap, b, y, g, pl);
  }
  return (int)cudaGetLastError();
}

template <int BN>
int run_bf16(bool im2col, const bf16* x, const bf16* w, const bf16* b, bf16* y, const Geometry& g,
             cudaStream_t stream) {
  // 128-pixel tiles (two consumer warpgroups) halve the weight bytes each
  // pixel costs; 64-pixel tiles fill more SMs. Take the one with fewer waves
  // of tile work (a 128-pixel tile counting twice), the larger on a tie;
  // im2col takes 128 only where its whole patch tile still fits.
  Plan one, two;
  const bool ok1 = plan_bf16<BN, 1>(im2col, g, one);
  const bool ok2 = plan_bf16<BN, 2>(im2col, g, two) && (!im2col || two.RA == two.NS);
  if (ok2 && (!ok1 || 2 * ceil_div(two.tiles, grid_slots<BN, 2>(two)) <=
                          ceil_div(one.tiles, grid_slots<BN, 1>(one))))
    return launch_bf16<BN, 2>(im2col, two, x, w, b, y, g, stream);
  if (!ok1) return (int)cudaErrorInvalidValue;
  return launch_bf16<BN, 1>(im2col, one, x, w, b, y, g, stream);
}

template <int BM, int BN, int kThreads, bool kIm2col>
int run_f32(const float* x, const float* w, const float* b, float* y, const Geometry& g,
            cudaStream_t stream) {
  Plan pl;
  pl.KC = ceil_div(g.C, kBK);
  pl.NS = 9 * pl.KC;
  pl.num_m = ceil_div(g.P(), BM);
  pl.tiles = pl.num_m * ceil_div(g.C, BN);
  const size_t slot_a = (size_t)BM * kBK * 4, ring_b = (size_t)kStagesF * kBK * BN * 4;
  pl.RA = kStagesF;
  if (kIm2col) {
    pl.RA = pl.NS;  // the patch tile, or as many of its chunks as fit
    while (pl.RA > kStagesF && pl.RA * slot_a + ring_b > (size_t)kMaxSmem) --pl.RA;
  }
  pl.S = pl.RB = kStagesF;
  const size_t smem = pl.RA * slot_a + ring_b;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static bool ready = false;
  auto kernel = conv_f32_kernel<BM, BN, kThreads, kIm2col>;
  cudaError_t rc = allow_smem(kernel, ready);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<dim3(pl.num_m, ceil_div(g.C, BN)), kThreads, smem, stream>>>(x, w, b, y, g, pl);
  return (int)cudaGetLastError();
}

template <int BN>
int run(bool im2col, bool is_bf16, const void* xp, const void* w, const void* bias, void* out,
        const Geometry& g, cudaStream_t s) {
  if (is_bf16)
    return run_bf16<BN>(im2col, static_cast<const bf16*>(xp), static_cast<const bf16*>(w),
                        static_cast<const bf16*>(bias), static_cast<bf16*>(out), g, s);
  const float* x = static_cast<const float*>(xp);
  const float* wt = static_cast<const float*>(w);
  const float* b = static_cast<const float*>(bias);
  float* y = static_cast<float*>(out);
  // im2col keeps its patch tile resident: 32 pixels a tile (147 KB at C = 128).
  return im2col ? run_f32<32, BN, 128, true>(x, wt, b, y, g, s)
                : run_f32<64, BN, 256, false>(x, wt, b, y, g, s);
}

int conv(bool im2col, const void* xp, const void* w, const void* bias, void* out, int B, int H,
         int W, int C, int out_pad, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 16 != 0 || (out_pad != 0 && out_pad != 1))
    return (int)cudaErrorInvalidValue;
  const Geometry g{B, H, W, C, out_pad};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return C <= 64 ? run<64>(im2col, is_bf16 != 0, xp, w, bias, out, g, s)
                 : run<128>(im2col, is_bf16 != 0, xp, w, bias, out, g, s);
}

}  // namespace

extern "C" const char* conv_probe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// y = relu(conv3x3(xp) + b) by nine shifted products. xp [B, H + 2, W + 2, C],
// w9 [9, C, C], b [1, C], all bfloat16 (is_bf16) or float32, contiguous, on
// the device, xp, w9 and out 16-byte aligned; out [B, H + 2 out_pad,
// W + 2 out_pad, C], written inside its border of out_pad. C must be a
// multiple of 16. Returns a cudaError_t.
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
