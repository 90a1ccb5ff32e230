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
// tree never leaves the chip, so bytes bound nothing. Each lane is a chain
// of dependent simulations, but 4,096 lanes keep every SM's schedulers full,
// so what bounds it is the instructions the SMs issue (and the shared-memory
// pipe they share), most of them doing little work: at cartpole's widths a
// layer keeps 2 to 21 of a warp's threads busy and the descent (A = 2) two
// (PERF.md, kernel 1: a clock64 breakdown of a simulation with one lane a
// warp put 25% of its time in the descent, 27% in the decodes, 36% in the
// MLPs).
//
// What the design does about that: it cuts the instructions a simulation
// issues and keeps every sum in the plain version's order.
// - A lane is a group of G threads: G = 16 (two lanes a warp) where the
//   block's eight trees fit its shared memory, else G = 32 (PERF.md, kernel
//   1: 16 against 32 at cartpole's and a 64-wide net's widths). Four warps
//   a block; the block's copy of the weights and its lanes' trees (visits,
//   value sums, rewards, players, children, priors, hidden states, path)
//   live in shared memory for the whole search.
// - The three heads advance together: a pass runs layer l of the reward,
//   policy and value MLPs at once, their outputs spread over the group. The
//   two support decodes and the policy softmax run across the group too:
//   each logit's exp once, on its own thread, a group max (fmaxf: exact in
//   any order), each sum sequential from index 0 on one thread (the three
//   sums on three threads at once), each quotient on its own thread.
// - The descent: the pUCT numerator from a per-launch table over the
//   parent's visit count (the same float32 expression: exact), exact table
//   divisions (div_rn, as csrc/mcts_kernels.cu; IEEE where an operand leaves
//   its range), the argmax a redux.sync max over an order-preserving key
//   and a redux.sync min over the indices holding it. The tie jitter's
//   Philox words are computed only where they can change the argmax: a
//   jitter word adds at most J = 2^32 x jitter_scale (rounded), so where the
//   best unjittered score exceeds the runner-up + J (rounded) every
//   jittered score keeps the order of the unjittered winner, and the words
//   are not needed.
// - The backprop, a short dependent chain, runs on one thread of the group,
//   with the table division.
// Each output of a layer is one thread's sequential dot product, as in the
// plain version.
//
// Arithmetic is f32 throughout, in the plain version's order: this file alone
// is compiled with --fmad=false (its flags in native/build.py) so every
// product is rounded before it is added, as by PyTorch's separate ops, and
// sums (the MLPs' dot products, the softmax denominators, the support
// expectation) run sequentially from index 0, as search_plain spells them
// out. ELU uses expm1f.
// Tie jitter: a Philox4x32-10 stream keyed by the wrapper's seed, counter
// (lane, simulation, level, action / 4); search_plain computes the same
// stream (ops/philox.py), so the two match with jitter on.

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
  float jitter_max;  // the most a jitter word adds: fl(2^32 * jitter_scale)
  uint32_t key0, key1;
  int lane_words;    // 4-byte words of shared memory per lane
  int weight_words;  // the block's copy of the weights
  int table_n;       // entries of the per-launch tables
  int soft_width;    // max(2 * support_size + 1, A): a softmax's length
};

namespace {

constexpr int kThreads = 128;  // four warps a block
constexpr int kNoEdge = 0x7fffffff;

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

__device__ __forceinline__ float pb_c_numerator(float p, const SearchArgs& args) {
  return (logf((p + args.pb_c_base + 1.f) / args.pb_c_base) + args.pb_c_init) * sqrtf(p);
}

// The launch's shared tables: the pUCT numerator of a parent visit count p,
// and 1 / b correctly rounded to double, for whole p, b in [0, n).
struct Tables {
  const float* num;
  const double* rcp;
  int n;
};

// a / b correctly rounded, without the branch of the IEEE division's slow
// path, for b a whole number in [1, tab.n) and a zero or finite with |a| >=
// 2^-100: RN_double(a * RN_double(1 / b)), rounded once to float (exact:
// see csrc/mcts_kernels.cu). ok is cleared where `need` and the operands
// leave that range.
__device__ __forceinline__ float div_rn(float a, float b, bool need, const Tables& tab,
                                        bool& ok) {
  const int bi = (int)b;
  const bool whole = (b >= 1.f) & ((float)bi == b) & (bi < tab.n);
  const float m = fabsf(a);
  const bool in_range = (a == 0.f) | ((m >= 0x1p-100f) & (m <= 3.4028234e38f));
  ok &= !need | (whole & in_range);
  return __double2float_rn((double)a * tab.rcp[whole ? bi : 1]);
}

// A key whose unsigned order is the float order of a score, -0 and +0 equal
// (as the plain version's argmax compares them), every real score (-inf
// included) above 0, the key of no edge and of a NaN score.
__device__ __forceinline__ uint32_t order_key(float s) {
  if (s != s) return 0u;
  const uint32_t u = __float_as_uint(s == 0.f ? 0.f : s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The score of a nonzero key.
__device__ __forceinline__ float key_score(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// A lane's group of G threads within its warp.
template <int G>
struct Group {
  unsigned mask;  // the group's threads
  int t;          // this thread's index in the group

  __device__ __forceinline__ void sync() const { __syncwarp(mask); }

  __device__ __forceinline__ float max(float v) const {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(mask, v, off, G));
    return v;
  }

  __device__ __forceinline__ float min(float v) const {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(mask, v, off, G));
    return v;
  }
};

// One dense layer of a lane's MLP: y[j] = act(sum_i x[i] W[i][j] + b[j]).
struct Layer {
  const float* W;  // [in][out], then b [out]
  const float* x;
  float* y;
  int fan_in, fan_out;
  bool act;
};

// Up to three independent layers in one pass of the group: their outputs,
// one after another, spread over the group's threads; each output's dot
// product is one thread's sequential sum from index 0.
template <int G>
__device__ __forceinline__ void dense(const Group<G>& g, const Layer* layers, int count) {
  int total = 0;
  for (int k = 0; k < count; ++k) total += layers[k].fan_out;
  for (int o = g.t; o < total; o += G) {
    int k = 0, j = o;
    while (j >= layers[k].fan_out) j -= layers[k++].fan_out;
    const Layer& L = layers[k];
    float acc = 0.f;
    for (int i = 0; i < L.fan_in; ++i) acc = acc + L.x[i] * L.W[i * L.fan_out + j];
    acc = acc + L.W[L.fan_in * L.fan_out + j];
    L.y[j] = L.act ? elu(acc) : acc;
  }
  g.sync();
}

// The layer of net index l, reading x and writing y.
__device__ __forceinline__ Layer layer(const NetDesc& net, const float* w_s, int l,
                                       const float* x, float* y, bool act) {
  return {w_s + net.w_off[l], x, y, net.in_dim[l], net.out_dim[l], act};
}

template <int G>
__global__ void __launch_bounds__(kThreads)
    mcts_fused_kernel(SearchArgs args, NetDesc net, const float* __restrict__ prior,
                      const float* __restrict__ hidden0, const float* __restrict__ root_reward,
                      const int* __restrict__ root_to_play, const int* __restrict__ root_legal,
                      const float* __restrict__ weights, int* __restrict__ out_visits,
                      float* __restrict__ out_value, int* __restrict__ out_depth) {
  constexpr int kLanes = kThreads / G;  // lanes per block
  extern __shared__ float smem[];
  const int A = args.A, E = args.E, N = args.N, S2 = 2 * args.support_size + 1;

  // ---- the block's copy of the weights, and the tables -------------------
  float* w_s = smem;
  for (int i = threadIdx.x; i < net.n_weights; i += kThreads) w_s[i] = weights[i];
  double* s_rcp = reinterpret_cast<double*>(smem + args.weight_words);
  float* s_num = reinterpret_cast<float*>(s_rcp + args.table_n);
  for (int p = threadIdx.x; p < args.table_n; p += kThreads) {
    s_num[p] = pb_c_numerator((float)p, args);
    s_rcp[p] = p > 0 ? 1.0 / (double)p : 0.0;
  }
  __syncthreads();
  const Tables tab = {s_num, s_rcp, args.table_n};

  const int slot = threadIdx.x / G;
  const int b = blockIdx.x * kLanes + slot;
  if (b >= args.B) return;  // no block-wide barrier follows
  const int base_t = (threadIdx.x & 31) & ~(G - 1);
  const Group<G> g = {G == 32 ? 0xffffffffu : (0xffffu << base_t), (int)threadIdx.x & (G - 1)};

  // ---- this lane's tree in shared memory --------------------------------
  const int tables_words = ((args.table_n * 3) + 3) & ~3;
  float* base = smem + args.weight_words + tables_words + slot * args.lane_words;
  int* visit = (int*)base;
  float* vsum = base + N;
  float* reward = base + 2 * N;
  int* to_play = (int*)(base + 3 * N);
  int* path = (int*)(base + 4 * N);
  int* child_index = (int*)(base + 5 * N);
  float* child_prior = base + 5 * N + N * A;
  float* hidden = base + 5 * N + 2 * N * A;
  int* legal = (int*)(hidden + N * E);
  float* raw_h = (float*)(legal + A);
  float* hbuf = raw_h + E;                     // [3 heads][2][max_width]
  float* soft = hbuf + 6 * net.max_width;      // [3][soft_width]: exps, then terms
  float* scalars = soft + 3 * args.soft_width; // min, max, three sums, two decodes

  for (int i = g.t; i < N; i += G) {
    visit[i] = 0;
    vsum[i] = 0.f;
    reward[i] = 0.f;
    to_play[i] = 0;
    path[i] = -1;
  }
  for (int i = g.t; i < N * A; i += G) {
    child_index[i] = -1;
    child_prior[i] = 0.f;
  }
  g.sync();
  for (int a = g.t; a < A; a += G) {
    child_prior[a] = prior[b * A + a];
    legal[a] = root_legal[b * A + a];
  }
  for (int e = g.t; e < E; e += G) hidden[e] = hidden0[b * E + e];
  if (g.t == 0) {
    reward[0] = root_reward[b];
    to_play[0] = root_to_play[b];
    path[0] = 0;
    scalars[0] = INFINITY;
    scalars[1] = -INFINITY;
  }
  g.sync();

  const float sign = args.num_players == 1 ? 1.f : -1.f;
  const float disc = args.discount;
  const float disc_sign = disc * sign;
  const bool jitter = args.jitter_scale > 0.f;
  const int rtp = root_to_play[b];
  const int rew0 = 1 + net.n_dyn_rest;
  const int head_first[3] = {rew0, rew0 + net.n_rew, rew0 + net.n_rew + net.n_pol};
  const int head_count[3] = {net.n_rew, net.n_pol, net.n_val};
  int maxd = 0;

  for (int sim = 0; sim < args.num_sims; ++sim) {
    const int new_node = sim + 1;
    const float mn = scalars[0], mx = scalars[1];
    const bool span_ok = mx > mn;
    const float inv_span = 1.f / fmaxf(mx - mn, 1e-30f);

    // ---- descend: follow max-pUCT edges to an unexpanded edge -----------
    int current = 0, depth = 0, parent = 0, action = 0;
    for (int level = 0; level < N; ++level) {
      const float pb = tab.num[visit[current]];  // counts never pass num_sims
      // The score of action a, in the plain version's operations and order.
      auto score = [&](int a, bool ieee, bool& ok) -> float {
        const int idx = child_index[current * A + a];
        const bool exists = idx >= 0;
        const float cvis = exists ? (float)visit[idx] : 0.f;
        const float cvsum = exists ? vsum[idx] : 0.f;
        const float crew = exists ? reward[idx] : 0.f;
        const bool visited = cvis > 0.f;
        const float vq = ieee ? cvsum / fmaxf(cvis, 1.f)
                              : div_rn(cvsum, fmaxf(cvis, 1.f), visited, tab, ok);
        const float cval = visited ? vq : 0.f;
        const float pq = ieee ? pb / (cvis + 1.f) : div_rn(pb, cvis + 1.f, true, tab, ok);
        const float q = crew + disc_sign * cval;
        const float qn = span_ok ? (q - mn) * inv_span : q;
        float s = pq * child_prior[current * A + a] + (visited ? qn : 0.f);
        if (current == 0 && legal[a] == 0) s = -INFINITY;
        return s;
      };
      // Each thread's best key (first action among equal keys) and its
      // runner-up, unjittered; IEEE divisions for the group where some
      // operand left div_rn's range.
      bool ok = true, ieee = false;
      uint32_t k1 = 0u, k2 = 0u;
      int a1 = kNoEdge;
      for (int pass = 0; pass < 2; ++pass) {
        k1 = k2 = 0u;
        a1 = kNoEdge;
        for (int a = g.t; a < A; a += G) {
          const uint32_t k = order_key(score(a, ieee, ok));
          if (k > k1) {
            k2 = k1;
            k1 = k;
            a1 = a;
          } else if (k > k2) {
            k2 = k;
          }
        }
        if (ieee || __all_sync(g.mask, ok)) break;
        ieee = true;
      }
      uint32_t top = __reduce_max_sync(g.mask, k1);
      auto first_holding = [&](uint32_t t, uint32_t k, int a) -> int {
        return t != 0u ? (int)__reduce_min_sync(g.mask, k == t ? (uint32_t)a : 0xffffffffu)
                       : A - 1;  // only if every score is NaN
      };
      int a_win = first_holding(top, k1, a1);
      if (jitter && top != 0u) {
        // The jitter can change the argmax only if the runner-up + J reaches
        // the winner (see the head of this file).
        const uint32_t second = __reduce_max_sync(g.mask, a1 == a_win ? k2 : k1);
        const float s_win = key_score(top);
        const bool settled = s_win == -INFINITY || second == 0u ||
                             s_win > key_score(second) + args.jitter_max;
        if (!settled) {  // group-uniform
          k1 = 0u;
          a1 = kNoEdge;
          for (int a = g.t; a < A; a += G) {
            const uint4 r = philox4x32_10(
                make_uint4((uint32_t)b, (uint32_t)sim, (uint32_t)level, (uint32_t)(a >> 2)),
                args.key0, args.key1);
            const uint32_t w = (a & 3) == 0 ? r.x : (a & 3) == 1 ? r.y : (a & 3) == 2 ? r.z : r.w;
            const uint32_t k = order_key(score(a, ieee, ok) + (float)w * args.jitter_scale);
            if (k > k1) {
              k1 = k;
              a1 = a;
            }
          }
          top = __reduce_max_sync(g.mask, k1);
          a_win = first_holding(top, k1, a1);
        }
      }
      const int child = child_index[current * A + a_win];
      if (child < 0) {
        parent = current;
        action = a_win;
        break;
      }
      current = child;
      depth += 1;
      if (g.t == 0) path[depth] = current;
    }
    const int leaf_depth = depth + 1;  // the new node sits one edge below

    // ---- recurrent inference --------------------------------------------
    float* h_next = hidden + new_node * E;
    {
      const float* h_par = hidden + parent * E;
      const int H0 = net.out_dim[0];
      const float* W = w_s + net.w_off[0];  // [E + A][H0]
      const float* b0 = W + (E + A) * H0;
      float* y = hbuf;
      for (int j = g.t; j < H0; j += G) {
        float acc = 0.f;
        for (int i = 0; i < E; ++i) acc = acc + h_par[i] * W[i * H0 + j];
        acc = acc + W[(E + action) * H0 + j];  // onehot @ W_a
        acc = acc + b0[j];
        y[j] = net.n_dyn_rest > 0 ? elu(acc) : acc;
      }
      g.sync();
      // The rest of the dynamics MLP; its last layer writes raw_h, the
      // UNNORMALIZED output.
      for (int l = 1; l <= net.n_dyn_rest; ++l) {
        float* out = l == net.n_dyn_rest ? raw_h : hbuf + (l & 1) * net.max_width;
        const Layer L = layer(net, w_s, l, y, out, l < net.n_dyn_rest);
        dense(g, &L, 1);
        y = out;
      }
      if (net.n_dyn_rest == 0) {
        for (int e = g.t; e < E; e += G) raw_h[e] = y[e];
        g.sync();
      }
      float lo = INFINITY, hi = -INFINITY;
      for (int e = g.t; e < E; e += G) {
        lo = fminf(lo, raw_h[e]);
        hi = fmaxf(hi, raw_h[e]);
      }
      lo = g.min(lo);
      hi = g.max(hi);
      float scale = hi - lo;
      if (scale < 1e-5f) scale = scale + 1e-5f;
      for (int e = g.t; e < E; e += G) h_next[e] = (raw_h[e] - lo) / scale;
      g.sync();
    }
    // The reward (on raw_h), policy and value (on h_next) MLPs, layer by
    // layer together; head k's logits end in logits[k].
    const float* logits[3];
    {
      const float* in[3] = {raw_h, h_next, h_next};
      const int depth_max = max(head_count[0], max(head_count[1], head_count[2]));
      for (int l = 0; l < depth_max; ++l) {
        Layer L[3];
        int count = 0;
        for (int k = 0; k < 3; ++k) {
          if (l >= head_count[k]) continue;
          float* out = hbuf + (2 * k + (l & 1)) * net.max_width;
          L[count++] = layer(net, w_s, head_first[k] + l, in[k], out, l < head_count[k] - 1);
          in[k] = out;
        }
        dense(g, L, count);
      }
      for (int k = 0; k < 3; ++k) logits[k] = in[k];
    }
    // Softmaxes: head k over n_k logits (the reward's and the value's S2,
    // the policy's A). exps[i] = expf(l_i - max) on thread i.
    const int n_soft[3] = {S2, A, S2};
    for (int k = 0; k < 3; ++k) {
      float m = -INFINITY;
      for (int i = g.t; i < n_soft[k]; i += G) m = fmaxf(m, logits[k][i]);
      m = g.max(m);
      for (int i = g.t; i < n_soft[k]; i += G)
        soft[k * args.soft_width + i] = expf(logits[k][i] - m);
    }
    g.sync();
    if (g.t < 3) {  // the three denominators at once, each from index 0
      const float* ex = soft + g.t * args.soft_width;
      float s = 0.f;
      for (int i = 0; i < n_soft[g.t]; ++i) s = s + ex[i];
      scalars[2 + g.t] = s;
    }
    g.sync();
    for (int k = 0; k < 3; ++k) {
      float* ex = soft + k * args.soft_width;
      const float s = scalars[2 + k];
      for (int i = g.t; i < n_soft[k]; i += G) {
        const float p = ex[i] / s;
        if (k == 1)  // the policy: the new node's priors, full action space
          child_prior[new_node * A + i] = p;
        else  // a support: the expectation's term
          ex[i] = p * (float)(i - args.support_size);
      }
    }
    g.sync();
    if (g.t == 0 || g.t == 2) {  // support_to_scalar's expectation and h^-1
      const float* term = soft + g.t * args.soft_width;
      float x = 0.f;
      for (int i = 0; i < S2; ++i) x = x + term[i];
      const float sgn = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
      const float y = (sqrtf(1.f + (float)(4.0 * 0.001) * (fabsf(x) + 1.f + 0.001f)) - 1.f) /
                      (float)(2.0 * 0.001);
      scalars[5 + g.t / 2] = sgn * (y * y - 1.f);
    }
    g.sync();

    // ---- expand node new_node, then backprop leaf -> root ----------------
    if (g.t == 0) {
      const float leaf_reward = scalars[5], leaf_value = scalars[6];
      const int vt_leaf = args.num_players == 1 ? 0 : ((rtp + leaf_depth) & 1);
      reward[new_node] = leaf_reward;
      to_play[new_node] = vt_leaf;
      child_index[parent * A + action] = new_node;
      path[leaf_depth] = new_node;

      float value = leaf_value;
      float smn = scalars[0], smx = scalars[1];
      for (int t = leaf_depth; t >= 0; --t) {
        const int node = path[t];
        const float nrew = reward[node];
        const bool same = to_play[node] == vt_leaf;
        const float delta = (args.num_players == 1 || same) ? value : -value;
        const float vs = vsum[node] + delta;
        const int nv = visit[node] + 1;
        vsum[node] = vs;
        visit[node] = nv;
        const float nvis = (float)nv;
        bool ok = true;
        float nval = div_rn(vs, fmaxf(nvis, 1.f), true, tab, ok);
        if (!ok) nval = vs / fmaxf(nvis, 1.f);
        const float stat = nrew + disc_sign * nval;
        smn = fminf(smn, stat);
        smx = fmaxf(smx, stat);
        if (args.num_players == 1)
          value = nrew + disc * value;
        else
          value = (same ? -nrew : nrew) + disc * value;
      }
      scalars[0] = smn;
      scalars[1] = smx;
    }
    maxd = max(maxd, leaf_depth);
    g.sync();
  }

  // ---- root statistics out ----------------------------------------------
  for (int a = g.t; a < A; a += G) {
    const int idx = child_index[a];
    out_visits[b * A + a] = idx >= 0 ? visit[idx] : 0;
  }
  if (g.t == 0) {
    const float rv = (float)visit[0];
    out_value[b] = rv > 0.f ? vsum[0] / fmaxf(rv, 1.f) : 0.f;
    out_depth[b] = maxd;
  }
}

// Launch mcts_fused_kernel<G> with `smem` bytes of shared memory.
template <int G>
int launch(const SearchArgs& args, const NetDesc& net, size_t smem, const float* prior,
           const float* hidden0, const float* root_reward, const int* to_play, const int* legal,
           const float* weights, int* out_visits, float* out_value, int* out_depth,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mcts_fused_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (args.B <= 0) return 0;
  constexpr int kLanes = kThreads / G;
  const int blocks = (args.B + kLanes - 1) / kLanes;
  mcts_fused_kernel<G><<<blocks, kThreads, smem, stream>>>(
      args, net, prior, hidden0, root_reward, to_play, legal, weights, out_visits, out_value,
      out_depth);
  return (int)cudaGetLastError();
}

}  // namespace

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
  args.jitter_max = 4294967296.0f * jitter_scale;  // (float) of the largest word, times the scale
  args.key0 = (uint32_t)(seed & 0xffffffffull);
  args.key1 = (uint32_t)(seed >> 32);
  const int N = args.N;
  args.weight_words = (net.n_weights + 3) & ~3;
  // Visit counts and their + 1 stay within [0, num_sims + 1].
  args.table_n = num_sims + 2;
  args.soft_width = S2 > A ? S2 : A;
  // visit, vsum, reward, to_play, path [N]; child index, prior [N*A];
  // hidden [N*E]; legal [A]; raw hidden [E]; the heads' activation buffers
  // [6 * maxw]; the softmaxes [3 * soft_width]; seven scalars.
  args.lane_words =
      (5 * N + 2 * N * A + N * E + A + E + 6 * maxw + 3 * args.soft_width + 7 + 3) & ~3;
  const int tables_words = (args.table_n * 3 + 3) & ~3;  // doubles, then floats
  auto smem_bytes = [&](int lanes) {
    return sizeof(float) *
           ((size_t)args.weight_words + tables_words + (size_t)lanes * args.lane_words);
  };
  const cudaStream_t s = (cudaStream_t)stream;
  // Two lanes a warp where the block fits (faster at 21- and 64-wide
  // layers alike, PERF.md, kernel 1), else one.
  if (smem_bytes(kThreads / 16) <= MAX_SMEM_BYTES)
    return launch<16>(args, net, smem_bytes(kThreads / 16), prior, hidden0, root_reward,
                      to_play, legal, weights, out_visits, out_value, out_depth, s);
  if (smem_bytes(kThreads / 32) > MAX_SMEM_BYTES) return -2;
  return launch<32>(args, net, smem_bytes(kThreads / 32), prior, hidden0, root_reward, to_play,
                    legal, weights, out_visits, out_value, out_depth, s);
}
