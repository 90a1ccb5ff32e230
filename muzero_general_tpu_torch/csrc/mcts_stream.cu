// The streaming search's two kernels, for Hopper (sm_90a): the descent over
// the packed edge slab and the backprop's edge updates.
//
// mcts_stream_descend replaces the TPU kernel
// muzero_general_tpu/ops/mcts_stream.py::_descend_stream_kernel (launched by
// descend_stream, from ops/mcts.py run_mcts on the stream route): all B
// trees descend by pUCT from the root to their first unexpanded edge, on the
// packed slab edges[B, N1, 8, A_pad] f32 (N1 = N + 1 rows, the last a dummy;
// planes visit, vsum, reward, prior, child index as f32), and record the
// path and the selected edges' (reward, visit, vsum) depth-major [D, B].
// mcts_stream_update replaces muzero_general_tpu/ops/mcts_stream.py::
// _update_edges_kernel (launched by update_edges, from backprop_stream): for
// every lane b and level t below the bound with mask 1, visit += mask and
// vsum += delta at edges[b, path_n[t, b], ., path_a[t, b]], in place.
//
// Their plain PyTorch versions are ops/mcts_stream.py::descend_stream_plain
// and ::update_edges_plain, which these kernels must match exactly: every
// descend output bit for bit, and every live slab row after an update (same
// float32 operations in the same order: this file is built with
// --fmad=false, its flags in native/build.py).
//
// What bounds them on this card. Neither moves enough bytes or does enough
// arithmetic to be bound by either: a gomoku descent reads five planes of
// A = 121 columns (2.4 KB) per lane and level, 64 lanes a few tens of levels
// deep, well under a megabyte per launch; an update touches two floats per
// live (lane, level). What bounds the descent is latency: each level is a
// dependent chain (the row's loads, two block reductions, then the chosen
// child decides the next row), so a launch costs about its deepest lane's
// chain. The update is one short dependent read-modify-write per thread, so
// it costs about a launch.
//
// What the design does about that. The TPU kernel streams one row per lane
// and level by DMA into VMEM and walks all B lanes in lockstep up to the
// batch-wide bound, because the TPU has one core and its scalar unit must
// issue every DMA. Here each lane gets its own block of 128 threads, one per
// action column, so 64 lanes run on 64 SMs at once and each stops at its own
// unexpanded edge. Per level a block loads its row's five planes (coalesced
// 484-byte reads), sums the visits (integers below 2^24: exact in any order)
// and takes the argmax of the scores, each by a warp shuffle and a pass over
// the four warps' partials in shared memory: two __syncthreads per level.
// The argmax carries the winner's stats and child, so thread 0 records the
// path from registers. The update needs neither the TPU kernel's upfront
// SMEM offsets nor its double-buffered row read-modify-writes: one thread
// per (level, lane) adds to its own edge. Within one call every live target
// is distinct (a descent never repeats an edge), so no atomics are needed;
// masked levels, aimed at the dummy row by backprop_stream, return early.
// Faster designs (several lanes per block, the update folded into the next
// descent, a CUDA graph around the simulation loop) are later work.
//
// Tie jitter: as in csrc/mcts_kernels.cu, a Philox4x32-10 stream keyed by
// the wrapper's seed, counter (lane, simulation, level, action / 4); the
// plain version computes the same stream (ops/philox.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPlanes = 8;  // S_PLANES
constexpr int kVisit = 0, kVsum = 1, kReward = 2, kPrior = 3, kChild = 4;
constexpr int kThreads = 128;  // one thread per padded action column
constexpr int kWarps = kThreads / 32;
constexpr int kUpdateThreads = 256;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += W0;
    k1 += W1;
  }
  return c;
}

// A candidate edge: its score and index, and what the descent records if it
// wins. better() takes the higher score, then the lower index (first-index
// argmax over equal scores, as the plain version's amin over the maxima).
struct Pick {
  float score;
  int a;
  float reward, visit, vsum;
  int child;
};

__device__ __forceinline__ bool better(float s, int a, const Pick& p) {
  return s > p.score || (s == p.score && a < p.a);
}

__device__ __forceinline__ Pick shfl_pick(const Pick& p, int off) {
  Pick o;
  o.score = __shfl_xor_sync(0xffffffffu, p.score, off);
  o.a = __shfl_xor_sync(0xffffffffu, p.a, off);
  o.reward = __shfl_xor_sync(0xffffffffu, p.reward, off);
  o.visit = __shfl_xor_sync(0xffffffffu, p.visit, off);
  o.vsum = __shfl_xor_sync(0xffffffffu, p.vsum, off);
  o.child = __shfl_xor_sync(0xffffffffu, p.child, off);
  return o;
}

struct DescendArgs {
  int B, N1, A, A_pad, D, sim;
  float pb_c_base, pb_c_init, disc_sign, jitter_scale;
  uint32_t key0, key1;
};

__global__ void __launch_bounds__(kThreads)
    descend_stream_kernel(DescendArgs args, const int* __restrict__ depth_bound,
                          const float* __restrict__ edges, const int* __restrict__ legal,
                          const float* __restrict__ min_value,
                          const float* __restrict__ max_value, int* __restrict__ out_parent,
                          int* __restrict__ out_action, int* __restrict__ out_depth,
                          int* __restrict__ path_n, int* __restrict__ path_a,
                          float* __restrict__ path_r, float* __restrict__ path_v,
                          float* __restrict__ path_s) {
  __shared__ float s_vis[kWarps];
  __shared__ Pick s_pick[kWarps];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = args.B, A = args.A, A_pad = args.A_pad, D = args.D;

  const float mn = min_value[b], mx = max_value[b];
  const bool span_ok = mx > mn;
  const float inv_span = 1.f / fmaxf(mx - mn, 1e-30f);
  // The caller's bound on the descent length, capped at the tree's depth.
  const int bound = min(*depth_bound, D - 1);
  const float* lane_rows = edges + (size_t)b * args.N1 * kPlanes * A_pad;
  if (tid == 0) path_n[b] = 0;  // the root at depth 0

  int current = 0, depth = 0, parent = 0, action = 0, t = 0;
  bool active = true;
  for (; t < bound && active; ++t) {
    const float* row = lane_rows + (size_t)current * kPlanes * A_pad;
    // visit(node): the sum of its edge visits, +1 for an interior node's
    // expansion (integers below 2^24: exact in any order).
    float part = 0.f;
    for (int a = tid; a < A; a += kThreads) part += row[kVisit * A_pad + a];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) s_vis[warp] = part;
    __syncthreads();
    float pvis = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) pvis += s_vis[w];
    pvis = pvis + (current != 0 ? 1.f : 0.f);
    const float pb_c_num =
        (logf((pvis + args.pb_c_base + 1.f) / args.pb_c_base) + args.pb_c_init) * sqrtf(pvis);

    Pick best = {-INFINITY, 0x7fffffff, 0.f, 0.f, 0.f, -1};
    for (int a = tid; a < A; a += kThreads) {
      const float cvis = row[kVisit * A_pad + a];
      const float cvsum = row[kVsum * A_pad + a];
      const float crew = row[kReward * A_pad + a];
      const float cval = cvis > 0.f ? cvsum / fmaxf(cvis, 1.f) : 0.f;
      const float prior_score = pb_c_num / (cvis + 1.f) * row[kPrior * A_pad + a];
      const float q = crew + args.disc_sign * cval;
      const float qn = span_ok ? (q - mn) * inv_span : q;
      float score = prior_score + (cvis > 0.f ? qn : 0.f);
      if (current == 0 && legal[(size_t)b * A + a] == 0) score = -INFINITY;
      if (args.jitter_scale > 0.f) {
        const uint4 r = philox4x32_10(
            make_uint4((uint32_t)b, (uint32_t)args.sim, (uint32_t)t, (uint32_t)(a >> 2)),
            args.key0, args.key1);
        const uint32_t w4[4] = {r.x, r.y, r.z, r.w};
        score = score + (float)w4[a & 3] * args.jitter_scale;
      }
      if (better(score, a, best)) {
        best.score = score;
        best.a = a;
        best.reward = crew;
        best.visit = cvis;
        best.vsum = cvsum;
        best.child = (int)row[kChild * A_pad + a];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const Pick o = shfl_pick(best, off);
      if (better(o.score, o.a, best)) best = o;
    }
    if (lane == 0) s_pick[warp] = best;
    __syncthreads();
    best = s_pick[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      if (better(s_pick[w].score, s_pick[w].a, best)) best = s_pick[w];
    if (best.a >= A) {  // only if every score is NaN
      best.a = 0;
      best.reward = row[kReward * A_pad];
      best.visit = row[kVisit * A_pad];
      best.vsum = row[kVsum * A_pad];
      best.child = (int)row[kChild * A_pad];
    }

    if (tid == 0) {
      const size_t i = (size_t)t * B + b;
      path_a[i] = best.a;
      path_r[i] = best.reward;
      path_v[i] = best.visit;
      path_s[i] = best.vsum;
    }
    if (best.child < 0) {
      parent = current;
      action = best.a;
      active = false;
    } else {
      current = best.child;
      depth += 1;
      if (tid == 0) path_n[(size_t)depth * B + b] = current;
    }
  }
  // Levels the lane did not reach keep the padding: node -1 past the last
  // recorded node, action and stats 0 past the last recorded level.
  for (int i = tid; i < D; i += kThreads) {
    const size_t k = (size_t)i * B + b;
    if (i > depth) path_n[k] = -1;
    if (i >= t) {
      path_a[k] = 0;
      path_r[k] = 0.f;
      path_v[k] = 0.f;
      path_s[k] = 0.f;
    }
  }
  if (tid == 0) {
    out_parent[b] = parent;
    out_action[b] = action;
    // A lane still descending after `bound` levels never reached an
    // unexpanded edge: the caller's depth bound was wrong. Mark it -1.
    out_depth[b] = active ? -1 : depth + 1;
  }
}

__global__ void __launch_bounds__(kUpdateThreads)
    update_edges_kernel(int B, int N1, int A_pad, int D, const int* __restrict__ bound,
                        float* __restrict__ edges, const int* __restrict__ path_n,
                        const int* __restrict__ path_a, const float* __restrict__ delta,
                        const float* __restrict__ mask) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= D * B) return;
  const int t = i / B, b = i - t * B;
  const float m = mask[i];
  if (t >= *bound || m == 0.f) return;
  float* row = edges + ((size_t)b * N1 + path_n[i]) * kPlanes * A_pad;
  const int a = path_a[i];
  row[kVisit * A_pad + a] = row[kVisit * A_pad + a] + m;
  row[kVsum * A_pad + a] = row[kVsum * A_pad + a] + delta[i];
}

}  // namespace

extern "C" const char* mcts_stream_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Descend B packed trees on `stream`, one block per lane. Device pointers
// throughout; depth_bound points at one int on the device. Returns a
// cudaError_t.
extern "C" int mcts_stream_descend(const int* depth_bound, const float* edges, const int* legal,
                                   const float* min_value, const float* max_value,
                                   int* out_parent, int* out_action, int* out_depth,
                                   int* path_n, int* path_a, float* path_r, float* path_v,
                                   float* path_s, int B, int N1, int A, int A_pad, int D,
                                   int sim, float pb_c_base, float pb_c_init, float disc_sign,
                                   float jitter_scale, unsigned long long seed, void* stream) {
  if (B <= 0) return 0;
  DescendArgs args;
  args.B = B;
  args.N1 = N1;
  args.A = A;
  args.A_pad = A_pad;
  args.D = D;
  args.sim = sim;
  args.pb_c_base = pb_c_base;
  args.pb_c_init = pb_c_init;
  args.disc_sign = disc_sign;
  args.jitter_scale = jitter_scale;
  args.key0 = (uint32_t)(seed & 0xffffffffull);
  args.key1 = (uint32_t)(seed >> 32);
  descend_stream_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      args, depth_bound, edges, legal, min_value, max_value, out_parent, out_action, out_depth,
      path_n, path_a, path_r, path_v, path_s);
  return (int)cudaGetLastError();
}

// Apply one simulation's edge updates to the packed slab on `stream`, in
// place, one thread per (level, lane) of the [D, B] path arrays; bound
// points at one int on the device. Returns a cudaError_t.
extern "C" int mcts_stream_update(const int* bound, float* edges, const int* path_n,
                                  const int* path_a, const float* delta, const float* mask,
                                  int B, int N1, int A_pad, int D, void* stream) {
  if (B <= 0 || D <= 0) return 0;
  const int blocks = (D * B + kUpdateThreads - 1) / kUpdateThreads;
  update_edges_kernel<<<blocks, kUpdateThreads, 0, (cudaStream_t)stream>>>(
      B, N1, A_pad, D, bound, edges, path_n, path_a, delta, mask);
  return (int)cudaGetLastError();
}
