// One row of the node-major hidden store, written in place, for Hopper
// (sm_90a).
//
// mcts_write_node_hidden replaces the TPU kernel
// muzero_general_tpu/ops/hidden_store.py::_row_write_kernel (launched by
// write_node_hidden): store[node] = leaf for an [N, B, *rest] store and a
// [B, *rest] leaf, touching only that row. `node` is an int on the device,
// read there, so a caller's simulation loop never waits on the host. A node
// outside [0, N) writes nothing. Its plain PyTorch version is
// ops/hidden_store.py::write_node_hidden_plain; the copy is exact.
//
// What bounds it on this card: bytes, and below a few megabytes the latency
// of the loads. It reads the leaf once and writes one row, 2 x B x F x
// itemsize bytes (connect4's 256 x 2,688 floats: 5.5 MB, 1.6 us at
// 3.35 TB/s), and computes nothing. A copy this small is over in a few
// memory latencies, so what costs is how many of them lie on each thread's
// path: the destination row depends on `node`, but the leaf does not.
//
// What the design does about that. One wave of blocks, two per SM, each
// with an even contiguous share of the row (at connect4's row 263 shares of
// 656 16-byte words), so every SM moves the same bytes: with fixed block
// shares, 168 blocks on 132 SMs would leave some SMs twice the work. Each
// thread issues its loads (up to four words in flight) and then its read of
// `node`, so both are in flight together; then it checks `node` and
// stores. So a thread pays one memory latency before its stores, not the
// two of reading `node` first. What is left above a copy to a fixed row is
// that the stores still wait for `node` to arrive.
// Neighbouring threads take neighbouring words, so every warp's loads and
// stores are coalesced. The word is the widest of 16, 4, 2 and 1 bytes that
// divides both base addresses and the row length, so every row of the store
// is aligned to it and no tail remains.
// A TMA design (per block, bulk copies global -> shared -> global, the
// load issued before `node` is read) measured slower at connect4's row and
// was dropped (PERF.md, kernel 7).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 4;  // words in flight per thread
constexpr int kBlocksPerSM = 2;

// The blocks of one wave: kBlocksPerSM on every SM of the current device.
int wave_blocks() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return kBlocksPerSM * sms;
}

// Block b copies words [b * share, (b + 1) * share) of the row.
template <typename W>
__global__ void __launch_bounds__(kThreads)
    row_write_kernel(const int* __restrict__ node, const W* __restrict__ leaf,
                     W* __restrict__ store, int N, size_t n_words, size_t share) {
  const size_t begin = (size_t)blockIdx.x * share;
  const size_t end = begin + share < n_words ? begin + share : n_words;
  size_t base = begin + threadIdx.x;
  if (base >= end) return;
  W v[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const size_t i = base + (size_t)k * kThreads;
    if (i < end) v[k] = __ldg(leaf + i);
  }
  const int n = __ldg(node);
  if (n < 0 || n >= N) return;
  W* dst = store + (size_t)n * n_words;
  for (;;) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const size_t i = base + (size_t)k * kThreads;
      if (i < end) dst[i] = v[k];
    }
    base += (size_t)kThreads * kWords;
    if (base >= end) break;
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const size_t i = base + (size_t)k * kThreads;
      if (i < end) v[k] = __ldg(leaf + i);
    }
  }
}

// An even share of n units over at most `blocks` blocks, rounded up to a
// multiple of `unit`; returns the share and sets blocks to the count used.
size_t even_share(size_t n, int& blocks, size_t unit) {
  size_t share = (n + blocks - 1) / blocks;
  share = (share + unit - 1) / unit * unit;
  blocks = (int)((n + share - 1) / share);
  return share;
}

template <typename W>
int launch_words(const int* node, const void* leaf, void* store, int N, size_t row_bytes,
                 cudaStream_t stream) {
  const size_t n_words = row_bytes / sizeof(W);
  int blocks = wave_blocks();
  // Shares of whole 128-byte lines where the row is long enough.
  const size_t share = even_share(n_words, blocks, 128 / sizeof(W));
  row_write_kernel<W><<<blocks, kThreads, 0, stream>>>(
      node, static_cast<const W*>(leaf), static_cast<W*>(store), N, n_words, share);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* hidden_store_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// store[*node] = leaf on `stream`: store is N rows of row_bytes bytes, leaf
// one row. Device pointers throughout. Returns a cudaError_t.
extern "C" int mcts_write_node_hidden(const int* node, const void* leaf, void* store, int N,
                                      unsigned long long row_bytes, void* stream) {
  if (N <= 0 || row_bytes == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t align = reinterpret_cast<uintptr_t>(leaf) |
                          reinterpret_cast<uintptr_t>(store) | (uintptr_t)row_bytes;
  if ((align & 15) == 0) return launch_words<uint4>(node, leaf, store, N, row_bytes, s);
  if ((align & 3) == 0) return launch_words<uint32_t>(node, leaf, store, N, row_bytes, s);
  if ((align & 1) == 0) return launch_words<uint16_t>(node, leaf, store, N, row_bytes, s);
  return launch_words<uint8_t>(node, leaf, store, N, row_bytes, s);
}
