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
// What bounds it on this card: bytes. It reads the leaf once and writes one
// row, 2 x B x F x itemsize bytes (connect4's 256 x 2,688 floats: 5.5 MB,
// 1.6 us at 3.35 TB/s), and computes nothing. The TPU kernel names the row
// through a scalar-prefetch index map and DMAs one block; here each thread
// copies 16 bytes (a uint4) where both rows are 16-byte aligned, with a
// scalar tail for the last bytes of a row whose length is no multiple of 16,
// and a 4-byte or 1-byte copy where the rows are not so aligned.
// Neighbouring threads take neighbouring 16-byte words, so every warp's
// loads and stores are coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void row_write_kernel(const int* __restrict__ node, const char* __restrict__ leaf,
                                 char* __restrict__ store, int N, size_t row_bytes) {
  const int n = *node;
  if (n < 0 || n >= N) return;
  char* dst = store + (size_t)n * row_bytes;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const uintptr_t align = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(leaf);
  size_t done = 0;
  if ((align & 15) == 0) {
    const size_t n16 = row_bytes >> 4;
    const uint4* src4 = reinterpret_cast<const uint4*>(leaf);
    uint4* dst4 = reinterpret_cast<uint4*>(dst);
    for (size_t i = tid; i < n16; i += stride) dst4[i] = src4[i];
    done = n16 << 4;
  } else if ((align & 3) == 0) {
    const size_t n4 = row_bytes >> 2;
    const uint32_t* src1 = reinterpret_cast<const uint32_t*>(leaf);
    uint32_t* dst1 = reinterpret_cast<uint32_t*>(dst);
    for (size_t i = tid; i < n4; i += stride) dst1[i] = src1[i];
    done = n4 << 2;
  }
  for (size_t i = done + tid; i < row_bytes; i += stride) dst[i] = leaf[i];
}

static const int kThreads = 256;
// Enough blocks for one 16-byte word a thread at connect4's row (172,032
// words); a larger row loops.
static const unsigned long long kMaxBlocks = 4096;

extern "C" const char* hidden_store_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// store[*node] = leaf on `stream`: store is N rows of row_bytes bytes, leaf
// one row. Device pointers throughout. Returns a cudaError_t.
extern "C" int mcts_write_node_hidden(const int* node, const void* leaf, void* store, int N,
                                      unsigned long long row_bytes, void* stream) {
  if (N <= 0 || row_bytes == 0) return 0;
  unsigned long long blocks = (row_bytes / 16 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  row_write_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      node, static_cast<const char*>(leaf), static_cast<char*>(store), N, (size_t)row_bytes);
  return (int)cudaGetLastError();
}
