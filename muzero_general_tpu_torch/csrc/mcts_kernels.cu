// The staged search's tree kernels, for Hopper (sm_90a): the descent (planar
// and node-major layouts, with an optional virtual-visit mark) and the
// leaf-to-root backprop (with an optional pre-marked mode).
//
// mcts_descend_planar replaces the TPU kernel
// muzero_general_tpu/ops/mcts_pallas.py::_descend_kernel_planar (launched by
// descend_planar, from ops/mcts.py _select_leaf): all B trees descend by
// pUCT from the root to their first unexpanded edge, on planar [B, A, N]
// edge slabs (edge (node, action) of lane b at (b * A + action) * N + node).
// With mark_visits (multi-leaf rounds, mcts_pallas.py:336-345) it adds +1 to
// the visit of every edge a lane takes, the final unexpanded one included,
// in place on the visit slab, after that level's pUCT has been scored.
// mcts_descend replaces mcts_pallas.py::_descend_kernel, the same descent on
// node-major [B, N, A] slabs (edge (node, action) at (b * N + node) * A +
// action); both layouts share one body, so on the same tree, seed and
// simulation they give the same outputs bit for bit.
// mcts_backprop replaces mcts_pallas.py::_backprop_kernel (launched by
// backprop, from ops/mcts.py): each lane folds its leaf value from the leaf
// to the root, updating edge visits and value sums, the root's scalars and
// the MinMaxStats in place, with two-player signs and the discount. Its edge
// offsets are node * stride_n + action * stride_a, so the planar (1, N) and
// the node-major (A, 1) layouts both work. pre_marked (multi-leaf rounds,
// mcts_pallas.py:469-477): the visits were marked by the descent, so it adds
// no edge or root visit and divides by max(visit, 1) instead of visit + 1.
//
// Their plain PyTorch versions are ops/mcts_kernels.py::descend_planar_plain,
// ::descend_plain and ::backprop_plain, which these kernels must match
// exactly: paths, actions, depths and visits bit for bit, value sums and
// min/max to the last bit as well (same float32 operations in the same
// order: this file is built with --fmad=false, its flags in native/build.py).
//
// What bounds them on this card. Neither does enough work to be bound by
// bytes or operations: a connect4 descent reads A = 7 edges of five stats
// per level, some 140 bytes, for a few levels per lane, and a backprop
// touches three values per level. At 256 lanes that is well under a
// megabyte per launch, under a microsecond at the card's 3.35 TB/s. What
// bounds them is latency: each level of a descent is a dependent chain (a
// global load of the node's edges, a log and a sqrt, a warp argmax, then
// the child's index decides the next load), and the backprop is a dependent
// read-modify-write chain along the path. So a launch costs roughly the
// deepest lane's chain plus the launch itself.
//
// What the design does about that. The TPU kernel's one-hot mask-reduce
// "gathers" and selection matmuls (Mosaic lacks narrow gathers) become
// direct indexing: each level reads only the current node's edges, and each
// lane stops at its own unexpanded edge instead of looping to the batch-wide
// bound. The descent gives each lane a warp, its threads over actions
// (strides of 32, so any A works), with a shuffle argmax that takes the
// first index among equal scores; the backprop gives each lane one thread
// that walks its own path and needs no batch-wide bound. Several lanes per
// block keep the SM's schedulers busy while one lane waits on a load.
// Nothing here allocates: the wrapper passes every output. Faster designs
// (the tree rows in shared memory, several lanes per warp, a CUDA graph
// around the simulation loop) are later work.
//
// Tie jitter: as in csrc/mcts_fused.cu, a Philox4x32-10 stream keyed by the
// wrapper's seed, counter (lane, simulation, level, action / 4); the plain
// versions compute the same stream (ops/philox.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

struct DescendArgs {
  int B, A, N, D, sim;
  float pb_c_base, pb_c_init, disc_sign, jitter_scale;
  uint32_t key0, key1;
};

// kPlanar: [B, A, N] slabs, else node-major [B, N, A]. kMark: +1 visit on
// every edge taken (the visit slab is then written).
template <bool kPlanar, bool kMark>
__global__ void descend_kernel(DescendArgs args, const int* __restrict__ depth_bound,
                               const int* __restrict__ child, const float* __restrict__ prior,
                               int* __restrict__ visit, const float* __restrict__ vsum,
                               const float* __restrict__ reward, const int* __restrict__ legal,
                               const float* __restrict__ min_value,
                               const float* __restrict__ max_value, int* __restrict__ out_parent,
                               int* __restrict__ out_action, int* __restrict__ out_depth,
                               int* __restrict__ path_n, int* __restrict__ path_a) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= args.B) return;  // whole warps leave together
  const int A = args.A, N = args.N, D = args.D;
  int* pn = path_n + (size_t)b * D;
  int* pa = path_a + (size_t)b * D;
  for (int i = lane; i < D; i += 32) {
    pn[i] = i == 0 ? 0 : -1;
    pa[i] = 0;
  }
  __syncwarp();

  const float mn = min_value[b], mx = max_value[b];
  const bool span_ok = mx > mn;
  const float inv_span = 1.f / fmaxf(mx - mn, 1e-30f);
  // The caller's bound on the descent length, capped at the tree's depth.
  const int bound = min(*depth_bound, D - 1);
  const size_t lane_base = (size_t)b * A * N;
  // Edge (node, action) of this lane.
  auto edge = [&](int node, int a) -> size_t {
    return lane_base + (kPlanar ? (size_t)a * N + node : (size_t)node * A + a);
  };

  int current = 0, depth = 0, parent = 0, action = 0;
  bool active = true;
  for (int t = 0; t < bound && active; ++t) {
    // visit(node): the sum of its edge visits, +1 for an interior node's
    // expansion (integers below 2^24: exact in any order).
    float part = 0.f;
    for (int a = lane; a < A; a += 32) part += (float)visit[edge(current, a)];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    const float pvis = part + (current != 0 ? 1.f : 0.f);
    const float pb_c_num =
        (logf((pvis + args.pb_c_base + 1.f) / args.pb_c_base) + args.pb_c_init) * sqrtf(pvis);

    float best_s = -INFINITY;
    int best_a = 0x7fffffff;
    for (int a = lane; a < A; a += 32) {
      const size_t e = edge(current, a);
      const float cvis = (float)visit[e];
      const float cval = cvis > 0.f ? vsum[e] / fmaxf(cvis, 1.f) : 0.f;
      const float prior_score = pb_c_num / (cvis + 1.f) * prior[e];
      const float q = reward[e] + args.disc_sign * cval;
      const float qn = span_ok ? (q - mn) * inv_span : q;
      float score = prior_score + (cvis > 0.f ? qn : 0.f);
      if (current == 0 && legal[b * A + a] == 0) score = -INFINITY;
      if (args.jitter_scale > 0.f) {
        const uint4 r = philox4x32_10(
            make_uint4((uint32_t)b, (uint32_t)args.sim, (uint32_t)t, (uint32_t)(a >> 2)),
            args.key0, args.key1);
        const uint32_t w4[4] = {r.x, r.y, r.z, r.w};
        score = score + (float)w4[a & 3] * args.jitter_scale;
      }
      if (score > best_s || (score == best_s && a < best_a)) {
        best_s = score;
        best_a = a;
      }
    }
    // warp argmax, first index among equal scores
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, best_s, off);
      const int oa = __shfl_xor_sync(0xffffffffu, best_a, off);
      if (os > best_s || (os == best_s && oa < best_a)) {
        best_s = os;
        best_a = oa;
      }
    }
    if (best_a >= A) best_a = 0;  // only if every score is NaN
    if (lane == 0) pa[t] = best_a;
    // The virtual-visit mark, after this level's scores (every thread's
    // loads of this node's visits fed the shuffles above, so none is still
    // pending). One thread adds: the warp owns its lane's slab, so there are
    // no atomics. No thread reads this entry again: the next level reads the
    // child's edges, and a descent never revisits a node.
    if (kMark && lane == 0) visit[edge(current, best_a)] += 1;
    const int next = child[edge(current, best_a)];
    if (next < 0) {
      parent = current;
      action = best_a;
      active = false;
    } else {
      current = next;
      depth += 1;
      if (lane == 0) pn[depth] = current;
    }
  }
  if (lane == 0) {
    out_parent[b] = parent;
    out_action[b] = action;
    // A lane still descending after `bound` levels never reached an
    // unexpanded edge: the caller's depth bound was wrong. Mark it -1.
    out_depth[b] = active ? -1 : depth + 1;
  }
}

struct BackpropArgs {
  int B, D, NA, stride_n, stride_a, num_players, pre_marked;
  float discount, disc_sign;
};

__global__ void backprop_kernel(BackpropArgs args, const int* __restrict__ path_n,
                                const int* __restrict__ path_a,
                                const int* __restrict__ leaf_depth,
                                const float* __restrict__ leaf_value,
                                const float* __restrict__ reward,
                                const float* __restrict__ root_reward, int* __restrict__ visit,
                                float* __restrict__ vsum, int* __restrict__ root_visit,
                                float* __restrict__ root_vsum, float* __restrict__ min_value,
                                float* __restrict__ max_value) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= args.B) return;
  const int L = leaf_depth[b];
  const int* pn = path_n + (size_t)b * args.D;
  const int* pa = path_a + (size_t)b * args.D;
  const size_t base = (size_t)b * args.NA;
  float value = leaf_value[b];
  float mn = min_value[b], mx = max_value[b];
  int rvis = root_visit[b];
  float rvsum = root_vsum[b];
  for (int t_rev = 0; t_rev <= L; ++t_rev) {
    const int t = L - t_rev;
    // node_to_play == the leaf's player <=> t_rev even (two players)
    const float sgn = (args.num_players == 1 || (t_rev & 1) == 0) ? 1.f : -1.f;
    const float delta = value * sgn;
    float nval, nrew;
    if (t >= 1) {  // the node's stats are its incoming edge's
      const size_t e = base + (size_t)pn[t - 1] * args.stride_n + (size_t)pa[t - 1] * args.stride_a;
      const float ev_old = (float)visit[e];
      const float es_new = vsum[e] + delta;
      vsum[e] = es_new;
      // Pre-marked: the descent already counted this visit, so the count
      // read is the new one.
      if (!args.pre_marked) visit[e] = visit[e] + 1;
      nval = es_new / (args.pre_marked ? fmaxf(ev_old, 1.f) : ev_old + 1.f);
      nrew = reward[e];
    } else {  // the root keeps explicit scalars
      rvsum = rvsum + delta;
      if (!args.pre_marked) rvis = rvis + 1;
      nval = rvsum / (float)max(rvis, 1);
      nrew = root_reward[b];
    }
    const float stat = nrew + args.disc_sign * nval;
    mn = fminf(mn, stat);
    mx = fmaxf(mx, stat);
    if (args.num_players == 1)
      value = nrew + args.discount * value;
    else
      value = -sgn * nrew + args.discount * value;
  }
  root_visit[b] = rvis;
  root_vsum[b] = rvsum;
  min_value[b] = mn;
  max_value[b] = mx;
}

static const int kDescendLanesPerBlock = 4;
static const int kBackpropThreads = 128;

extern "C" const char* mcts_kernels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

static int launch_descend(bool planar, bool mark, const int* depth_bound, const int* child,
                          const float* prior, int* visit, const float* vsum, const float* reward,
                          const int* legal, const float* min_value, const float* max_value,
                          int* out_parent, int* out_action, int* out_depth, int* path_n,
                          int* path_a, int B, int A, int N, int D, int sim, float pb_c_base,
                          float pb_c_init, float disc_sign, float jitter_scale,
                          unsigned long long seed, void* stream) {
  if (B <= 0) return 0;
  DescendArgs args;
  args.B = B;
  args.A = A;
  args.N = N;
  args.D = D;
  args.sim = sim;
  args.pb_c_base = pb_c_base;
  args.pb_c_init = pb_c_init;
  args.disc_sign = disc_sign;
  args.jitter_scale = jitter_scale;
  args.key0 = (uint32_t)(seed & 0xffffffffull);
  args.key1 = (uint32_t)(seed >> 32);
  const int blocks = (B + kDescendLanesPerBlock - 1) / kDescendLanesPerBlock;
  const int threads = 32 * kDescendLanesPerBlock;
  cudaStream_t s = (cudaStream_t)stream;
#define MCTS_DESCEND(P, M)                                                                     \
  descend_kernel<P, M><<<blocks, threads, 0, s>>>(args, depth_bound, child, prior, visit, vsum, \
                                                  reward, legal, min_value, max_value,          \
                                                  out_parent, out_action, out_depth, path_n,    \
                                                  path_a)
  if (!planar)
    MCTS_DESCEND(false, false);
  else if (mark)
    MCTS_DESCEND(true, true);
  else
    MCTS_DESCEND(true, false);
#undef MCTS_DESCEND
  return (int)cudaGetLastError();
}

// Descend B planar trees on `stream`; with mark_visits, +1 on every edge
// taken, in place on `visit`. Device pointers throughout; depth_bound points
// at one int on the device. Returns a cudaError_t.
extern "C" int mcts_descend_planar(const int* depth_bound, const int* child, const float* prior,
                                   int* visit, const float* vsum, const float* reward,
                                   const int* legal, const float* min_value,
                                   const float* max_value, int* out_parent, int* out_action,
                                   int* out_depth, int* path_n, int* path_a, int B, int A,
                                   int N, int D, int sim, int mark_visits, float pb_c_base,
                                   float pb_c_init, float disc_sign, float jitter_scale,
                                   unsigned long long seed, void* stream) {
  return launch_descend(true, mark_visits != 0, depth_bound, child, prior, visit, vsum, reward,
                        legal, min_value, max_value, out_parent, out_action, out_depth, path_n,
                        path_a, B, A, N, D, sim, pb_c_base, pb_c_init, disc_sign, jitter_scale,
                        seed, stream);
}

// Descend B node-major [B, N, A] trees on `stream`, as mcts_descend_planar
// without the mark (visit is only read). Returns a cudaError_t.
extern "C" int mcts_descend(const int* depth_bound, const int* child, const float* prior,
                            const int* visit, const float* vsum, const float* reward,
                            const int* legal, const float* min_value, const float* max_value,
                            int* out_parent, int* out_action, int* out_depth, int* path_n,
                            int* path_a, int B, int A, int N, int D, int sim, float pb_c_base,
                            float pb_c_init, float disc_sign, float jitter_scale,
                            unsigned long long seed, void* stream) {
  return launch_descend(false, false, depth_bound, child, prior, const_cast<int*>(visit), vsum,
                        reward, legal, min_value, max_value, out_parent, out_action, out_depth,
                        path_n, path_a, B, A, N, D, sim, pb_c_base, pb_c_init, disc_sign,
                        jitter_scale, seed, stream);
}

// Back up B leaf values on `stream`, in place on visit, vsum, root_visit,
// root_vsum, min_value and max_value (pre_marked: vsum, root_vsum and the
// min/max only). Device pointers throughout. Returns a
// cudaError_t.
// The pointers come in the wrapper's argument order (ops/mcts_kernels.py
// backprop).
extern "C" int mcts_backprop(const int* path_n, const int* path_a, const int* leaf_depth,
                             const float* leaf_value, int* visit, float* vsum,
                             const float* reward, int* root_visit, float* root_vsum,
                             const float* root_reward, float* min_value, float* max_value,
                             int B, int D, int NA, int stride_n, int stride_a,
                             int num_players, int pre_marked, float discount, float disc_sign,
                             void* stream) {
  if (B <= 0) return 0;
  BackpropArgs args;
  args.B = B;
  args.D = D;
  args.NA = NA;
  args.stride_n = stride_n;
  args.stride_a = stride_a;
  args.num_players = num_players;
  args.pre_marked = pre_marked != 0;
  args.discount = discount;
  args.disc_sign = disc_sign;
  const int blocks = (B + kBackpropThreads - 1) / kBackpropThreads;
  backprop_kernel<<<blocks, kBackpropThreads, 0, (cudaStream_t)stream>>>(
      args, path_n, path_a, leaf_depth, leaf_value, reward, root_reward, visit, vsum, root_visit,
      root_vsum, min_value, max_value);
  return (int)cudaGetLastError();
}
