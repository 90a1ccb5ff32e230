// Fused MCTS search for fully connected MuZero networks, for Hopper (sm_90a).
//
// Replaces the TPU kernel muzero_general_tpu/ops/mcts_fused.py::_search_kernel
// (launched by _search, from run_mcts_fused). One launch runs the whole
// S-simulation pUCT search for B lanes: descend, the FC recurrent inference
// (dynamics, reward, policy and value MLPs), support decode, expand, and
// backprop with MinMaxStats. Its plain PyTorch version is
// ops/mcts_fused.py::search_plain, which this kernel must match: exact visit
// counts and depth, values to float rounding.
//
// What bounds it on this card. The work is small: about 1.4 k multiply-adds
// of MLP per simulation per lane at cartpole widths, so one move at 4,096
// lanes x 50 simulations is about 0.56 GFLOP, some 8 us at the card's
// 67 TFLOP/s in f32; the inputs and outputs are a few hundred KB, and the
// tree never leaves the chip, so bytes bound nothing. What bounds it is
// latency: each lane is a chain of 50 dependent simulations, each a
// data-dependent walk down the tree, eight or so dependent MLP layers and a
// walk back up.
//
// What the design does about that. One warp per lane, several lanes per block,
// so the SM's schedulers hide one lane's shared-memory and math latency
// behind the other resident lanes (4,096 lanes fill the 132 SMs at some 31
// warps each). Each lane's tree (visits, value sums, rewards, players,
// children, priors, hidden states, path) lives in shared memory for the
// whole search, and the block's copy of the flat weights is loaded once.
// Each MLP layer spreads its outputs over the warp's threads; the descent
// scores a node's actions in parallel and takes a warp argmax; the backprop,
// a short dependent chain, runs on one thread. The TPU kernel's one-hot
// "selection matmuls" (Mosaic has no narrow gathers) are plain indexing here.
//
// Arithmetic is f32 throughout, in the plain version's order: this file alone
// is compiled with --fmad=false (its flags in native/build.py) so every
// product is rounded before it is added, as by PyTorch's separate ops, and
// sums (the MLPs' dot products, the softmax denominators, the support
// expectation) run sequentially from index 0, as search_plain spells them
// out. ELU uses expm1f.
// Tie jitter: a Philox4x32-10 stream keyed by the wrapper's seed, counter
// (lane, simulation, level, action / 4); search_plain computes the same
// stream (mcts_fused.py philox4x32_10), so the two match with jitter on.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_LAYERS 32
#define MAX_SMEM_BYTES (227 * 1024)

struct NetDesc {
  int n_layers;   // total layers: 1 + n_dyn_rest + n_rew + n_pol + n_val
  int n_dyn_rest; // dynamics layers after the split first one
  int n_rew, n_pol, n_val;
  int in_dim[MAX_LAYERS];
  int out_dim[MAX_LAYERS];
  int w_off[MAX_LAYERS]; // float offset of W [in][out]; b follows it
  int n_weights;         // floats in the flat weight buffer
  int max_width;         // widest layer input or output
};

struct SearchArgs {
  int B, A, E, N, num_sims, num_players, support_size;
  float pb_c_base, pb_c_init, discount, jitter_scale;
  uint32_t key0, key1;
  int warp_words; // 4-byte words of shared memory per lane
  int weight_words;
};

// ---- Philox4x32-10 (Salmon et al., SC'11) ------------------------------
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

__device__ __forceinline__ float elu(float x) { return x > 0.f ? x : expm1f(x); }

// y[j] = act(sum_i x[i] W[i][j] + b[j]) for j over the warp's threads.
__device__ __forceinline__ void dense(const float* W, const float* b, const float* x,
                                      float* y, int fan_in, int fan_out, bool apply_elu,
                                      int lane) {
  __syncwarp();
  for (int j = lane; j < fan_out; j += 32) {
    float acc = 0.f;
    for (int i = 0; i < fan_in; ++i) acc = acc + x[i] * W[i * fan_out + j];
    acc = acc + b[j];
    y[j] = apply_elu ? elu(acc) : acc;
  }
  __syncwarp();
}

// Layers [first, first + count) of the net: ELU between, identity output.
// Outputs alternate between buf0 and buf1 (x must be neither's first use).
__device__ const float* mlp(const NetDesc& net, const float* w_s, int first, int count,
                            const float* x, float* buf0, float* buf1, int lane) {
  const float* in = x;
  float* out = buf0;
  for (int l = 0; l < count; ++l) {
    const int L = first + l;
    const float* W = w_s + net.w_off[L];
    dense(W, W + net.in_dim[L] * net.out_dim[L], in, out, net.in_dim[L], net.out_dim[L],
          l < count - 1, lane);
    in = out;
    out = (out == buf0) ? buf1 : buf0;
  }
  return in;
}

// support_to_scalar: softmax -> expectation -> h^-1 (reference models.py:645-666).
// Every thread computes it from the same shared logits.
__device__ float decode(const float* logits, int support_size) {
  const int S2 = 2 * support_size + 1;
  float m = logits[0];
  for (int i = 1; i < S2; ++i) m = fmaxf(m, logits[i]);
  float s = 0.f;
  for (int i = 0; i < S2; ++i) s = s + expf(logits[i] - m);
  float x = 0.f;
  for (int i = 0; i < S2; ++i) {
    const float p = expf(logits[i] - m) / s;
    x = x + p * (float)(i - support_size);
  }
  const float sgn = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float y = (sqrtf(1.f + (float)(4.0 * 0.001) * (fabsf(x) + 1.f + 0.001f)) - 1.f) /
                  (float)(2.0 * 0.001);
  return sgn * (y * y - 1.f);
}

__global__ void mcts_fused_kernel(SearchArgs args, NetDesc net, const float* __restrict__ prior,
                                  const float* __restrict__ hidden0,
                                  const float* __restrict__ root_reward,
                                  const int* __restrict__ root_to_play,
                                  const int* __restrict__ root_legal,
                                  const float* __restrict__ weights, int* __restrict__ out_visits,
                                  float* __restrict__ out_value, int* __restrict__ out_depth) {
  extern __shared__ float smem[];
  const int A = args.A, E = args.E, N = args.N;

  // ---- the block's copy of the weights ----------------------------------
  float* w_s = smem;
  for (int i = threadIdx.x; i < net.n_weights; i += blockDim.x) w_s[i] = weights[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= args.B) return;  // no block-wide barrier follows

  // ---- this lane's tree in shared memory --------------------------------
  float* base = smem + args.weight_words + warp * args.warp_words;
  int* visit = (int*)base;
  float* vsum = base + N;
  float* reward = base + 2 * N;
  int* to_play = (int*)(base + 3 * N);
  int* path = (int*)(base + 4 * N);
  int* child_index = (int*)(base + 5 * N);
  float* child_prior = base + 5 * N + N * A;
  float* hidden = base + 5 * N + 2 * N * A;
  int* legal = (int*)(hidden + N * E);
  float* buf0 = (float*)(legal + A);
  float* buf1 = buf0 + net.max_width;
  float* raw_h = buf1 + net.max_width;
  float* stats = raw_h + E;  // [0] = min, [1] = max of MinMaxStats

  for (int i = lane; i < N; i += 32) {
    visit[i] = 0;
    vsum[i] = 0.f;
    reward[i] = 0.f;
    to_play[i] = 0;
    path[i] = -1;
  }
  for (int i = lane; i < N * A; i += 32) {
    child_index[i] = -1;
    child_prior[i] = 0.f;
  }
  __syncwarp();
  for (int a = lane; a < A; a += 32) {
    child_prior[a] = prior[b * A + a];
    legal[a] = root_legal[b * A + a];
  }
  for (int e = lane; e < E; e += 32) hidden[e] = hidden0[b * E + e];
  if (lane == 0) {
    reward[0] = root_reward[b];
    to_play[0] = root_to_play[b];
    path[0] = 0;
    stats[0] = INFINITY;
    stats[1] = -INFINITY;
  }
  __syncwarp();

  const float sign = args.num_players == 1 ? 1.f : -1.f;
  const float disc = args.discount;
  const float disc_sign = disc * sign;
  const int rtp = root_to_play[b];
  int maxd = 0;

  for (int sim = 0; sim < args.num_sims; ++sim) {
    const int new_node = sim + 1;
    const float mn = stats[0], mx = stats[1];
    const bool span_ok = mx > mn;
    const float inv_span = 1.f / fmaxf(mx - mn, 1e-30f);

    // ---- descend: follow max-pUCT edges to an unexpanded edge -----------
    int current = 0, depth = 0, parent = 0, action = 0;
    for (int level = 0; level < N; ++level) {
      const float pvis = (float)visit[current];
      const float pb_c_num =
          (logf((pvis + args.pb_c_base + 1.f) / args.pb_c_base) + args.pb_c_init) * sqrtf(pvis);
      float best_s = -INFINITY;
      int best_a = 0x7fffffff;
      for (int a = lane; a < A; a += 32) {
        const int idx = child_index[current * A + a];
        const bool exists = idx >= 0;
        const float cvis = exists ? (float)visit[idx] : 0.f;
        const float cvsum = exists ? vsum[idx] : 0.f;
        const float crew = exists ? reward[idx] : 0.f;
        const float cval = cvis > 0.f ? cvsum / fmaxf(cvis, 1.f) : 0.f;
        const float pb_c = pb_c_num / (cvis + 1.f);
        const float prior_score = pb_c * child_prior[current * A + a];
        const float q = crew + disc_sign * cval;
        const float qn = span_ok ? (q - mn) * inv_span : q;
        float score = prior_score + (cvis > 0.f ? qn : 0.f);
        if (current == 0 && legal[a] == 0) score = -INFINITY;
        if (args.jitter_scale > 0.f) {
          const uint4 r = philox4x32_10(
              make_uint4((uint32_t)b, (uint32_t)sim, (uint32_t)level, (uint32_t)(a >> 2)),
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
      if (best_a >= A) best_a = A - 1;  // only if every score is NaN
      const int child = child_index[current * A + best_a];
      if (child < 0) {
        parent = current;
        action = best_a;
        break;
      }
      current = child;
      depth += 1;
      if (lane == 0) path[depth] = current;
    }
    const int leaf_depth = depth + 1;  // the new node sits one edge below

    // ---- recurrent inference --------------------------------------------
    {
      const float* h_par = hidden + parent * E;
      const int H0 = net.out_dim[0];
      const float* W = w_s + net.w_off[0];  // [E + A][H0]
      const float* b0 = W + (E + A) * H0;
      for (int j = lane; j < H0; j += 32) {
        float acc = 0.f;
        for (int i = 0; i < E; ++i) acc = acc + h_par[i] * W[i * H0 + j];
        acc = acc + W[(E + action) * H0 + j];  // onehot @ W_a
        acc = acc + b0[j];
        buf0[j] = net.n_dyn_rest > 0 ? elu(acc) : acc;
      }
      __syncwarp();
      const float* x = buf0;
      if (net.n_dyn_rest > 0) x = mlp(net, w_s, 1, net.n_dyn_rest, buf0, buf1, buf0, lane);
      for (int e = lane; e < E; e += 32) raw_h[e] = x[e];  // UNNORMALIZED output
      __syncwarp();
    }
    float* h_next = hidden + new_node * E;
    {
      float hmin = raw_h[0], hmax = raw_h[0];
      for (int e = 1; e < E; ++e) {
        hmin = fminf(hmin, raw_h[e]);
        hmax = fmaxf(hmax, raw_h[e]);
      }
      float scale = hmax - hmin;
      if (scale < 1e-5f) scale = scale + 1e-5f;
      for (int e = lane; e < E; e += 32) h_next[e] = (raw_h[e] - hmin) / scale;
      __syncwarp();
    }
    const int rew0 = 1 + net.n_dyn_rest;
    const int pol0 = rew0 + net.n_rew;
    const int val0 = pol0 + net.n_pol;
    const float leaf_reward =
        decode(mlp(net, w_s, rew0, net.n_rew, raw_h, buf0, buf1, lane), args.support_size);
    __syncwarp();
    {
      const float* logits = mlp(net, w_s, pol0, net.n_pol, h_next, buf0, buf1, lane);
      float pm = logits[0];
      for (int a = 1; a < A; ++a) pm = fmaxf(pm, logits[a]);
      float ps = 0.f;
      for (int a = 0; a < A; ++a) ps = ps + expf(logits[a] - pm);
      for (int a = lane; a < A; a += 32)  // full action space at interior nodes
        child_prior[new_node * A + a] = expf(logits[a] - pm) / ps;
      __syncwarp();
    }
    const float leaf_value =
        decode(mlp(net, w_s, val0, net.n_val, h_next, buf0, buf1, lane), args.support_size);
    __syncwarp();

    // ---- expand node new_node, then backprop leaf -> root ----------------
    if (lane == 0) {
      const int vt_leaf = args.num_players == 1 ? 0 : ((rtp + leaf_depth) & 1);
      reward[new_node] = leaf_reward;
      to_play[new_node] = vt_leaf;
      child_index[parent * A + action] = new_node;
      path[leaf_depth] = new_node;

      float value = leaf_value;
      float smn = stats[0], smx = stats[1];
      for (int t = leaf_depth; t >= 0; --t) {
        const int node = path[t];
        const float nrew = reward[node];
        const bool same = to_play[node] == vt_leaf;
        const float delta = (args.num_players == 1 || same) ? value : -value;
        vsum[node] = vsum[node] + delta;
        visit[node] = visit[node] + 1;
        const float nvis = (float)visit[node];
        const float nval = nvis > 0.f ? vsum[node] / fmaxf(nvis, 1.f) : 0.f;
        const float stat = nrew + disc_sign * nval;
        smn = fminf(smn, stat);
        smx = fmaxf(smx, stat);
        if (args.num_players == 1)
          value = nrew + disc * value;
        else
          value = (same ? -nrew : nrew) + disc * value;
      }
      stats[0] = smn;
      stats[1] = smx;
    }
    maxd = max(maxd, leaf_depth);
    __syncwarp();
  }

  // ---- root statistics out ----------------------------------------------
  for (int a = lane; a < A; a += 32) {
    const int idx = child_index[a];
    out_visits[b * A + a] = idx >= 0 ? visit[idx] : 0;
  }
  if (lane == 0) {
    const float rv = (float)visit[0];
    out_value[b] = rv > 0.f ? vsum[0] / fmaxf(rv, 1.f) : 0.f;
    out_depth[b] = maxd;
  }
}

static const int kLanesPerBlock = 4;

extern "C" const char* mcts_fused_error_string(int code) {
  if (code == -1) return "unsupported network layout (layer count or widths)";
  if (code == -2) return "a lane's tree and the weights exceed the block's shared memory";
  return cudaGetErrorString((cudaError_t)code);
}

// Launch the search on `stream`. Pointers are device pointers except
// layer_counts [4] = (dynamics layers after the first, reward, policy, value)
// and layer_dims [2 * n_layers] = (in, out) per layer, which are host arrays.
// Returns 0, a cudaError_t, or a negative code (mcts_fused_error_string).
extern "C" int mcts_fused_search(const float* prior, const float* hidden0,
                                 const float* root_reward, const int* to_play, const int* legal,
                                 const float* weights, int* out_visits, float* out_value,
                                 int* out_depth, int B, int A, int E, int num_sims,
                                 int num_players, int support_size, float pb_c_base,
                                 float pb_c_init, float discount, float jitter_scale,
                                 unsigned long long seed, const int* layer_counts,
                                 const int* layer_dims, int n_layers, void* stream) {
  NetDesc net;
  net.n_layers = n_layers;
  net.n_dyn_rest = layer_counts[0];
  net.n_rew = layer_counts[1];
  net.n_pol = layer_counts[2];
  net.n_val = layer_counts[3];
  const int S2 = 2 * support_size + 1;
  if (n_layers > MAX_LAYERS || n_layers != 1 + net.n_dyn_rest + net.n_rew + net.n_pol + net.n_val ||
      net.n_dyn_rest < 0 || net.n_rew < 1 || net.n_pol < 1 || net.n_val < 1)
    return -1;
  int off = 0, maxw = 0;
  for (int l = 0; l < n_layers; ++l) {
    net.in_dim[l] = layer_dims[2 * l];
    net.out_dim[l] = layer_dims[2 * l + 1];
    net.w_off[l] = off;
    off += net.in_dim[l] * net.out_dim[l] + net.out_dim[l];
    maxw = net.in_dim[l] > maxw ? net.in_dim[l] : maxw;
    maxw = net.out_dim[l] > maxw ? net.out_dim[l] : maxw;
  }
  net.n_weights = off;
  net.max_width = maxw;
  // Shapes the search relies on: the dynamics MLP maps E + A -> E, the
  // reward and value heads end in S2 logits, the policy head in A.
  const int last_dyn = net.n_dyn_rest;
  const int last_rew = last_dyn + net.n_rew, last_pol = last_rew + net.n_pol;
  if (net.in_dim[0] != E + A || net.out_dim[last_dyn] != E || net.in_dim[last_dyn + 1] != E ||
      net.out_dim[last_rew] != S2 || net.in_dim[last_rew + 1] != E ||
      net.out_dim[last_pol] != A || net.in_dim[last_pol + 1] != E ||
      net.out_dim[n_layers - 1] != S2)
    return -1;
  for (int l = 1; l < n_layers; ++l) {
    const bool first_of_mlp = l == last_dyn + 1 || l == last_rew + 1 || l == last_pol + 1;
    if (!first_of_mlp && net.in_dim[l] != net.out_dim[l - 1]) return -1;
  }

  SearchArgs args;
  args.B = B;
  args.A = A;
  args.E = E;
  args.N = num_sims + 1;
  args.num_sims = num_sims;
  args.num_players = num_players;
  args.support_size = support_size;
  args.pb_c_base = pb_c_base;
  args.pb_c_init = pb_c_init;
  args.discount = discount;
  args.jitter_scale = jitter_scale;
  args.key0 = (uint32_t)(seed & 0xffffffffull);
  args.key1 = (uint32_t)(seed >> 32);
  const int N = args.N;
  args.weight_words = (net.n_weights + 3) & ~3;
  // visit, vsum, reward, to_play, path [N]; child index, prior [N*A];
  // hidden [N*E]; legal [A]; two activation buffers; raw hidden [E]; min/max.
  args.warp_words = (5 * N + 2 * N * A + N * E + A + 2 * maxw + E + 2 + 3) & ~3;
  const size_t smem =
      sizeof(float) * ((size_t)args.weight_words + (size_t)kLanesPerBlock * args.warp_words);
  if (smem > MAX_SMEM_BYTES) return -2;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(mcts_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (B <= 0) return 0;
  const int blocks = (B + kLanesPerBlock - 1) / kLanesPerBlock;
  mcts_fused_kernel<<<blocks, 32 * kLanesPerBlock, smem, (cudaStream_t)stream>>>(
      args, net, prior, hidden0, root_reward, to_play, legal, weights, out_visits, out_value,
      out_depth);
  return (int)cudaGetLastError();
}
