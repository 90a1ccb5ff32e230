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
// the child's index decides the next load), and the backprop's walk from
// leaf to root, where only the value recurrence is truly serial. So a
// launch costs roughly the deepest lane's chain plus the launch itself.
//
// What the design does about that. The TPU kernel's one-hot mask-reduce
// "gathers" and selection matmuls (Mosaic lacks narrow gathers) become
// direct indexing: each level reads only the current node's edges, and each
// lane stops at its own unexpanded edge instead of looping to the batch-wide
// bound. The descent keeps one level's chain to one memory round trip and
// little else (a dependent global load costs ~1,000 cycles on this card,
// PERF.md, kernel 2):
// - One warp per lane, one lane a block, so 256 lanes spread over every SM;
//   seven more warps of the block help build the launch's tables while the
//   root's loads are in flight, then leave. Where A <= 32 each thread owns
//   one action and issues its five loads (visit, value sum, prior, reward,
//   child; the legal flag at the root) together; nothing is used before all
//   are issued, and the next node's loads are issued as soon as the argmax
//   names it, before the level's records. Wider rows are read in two passes
//   (off every game's path).
// - Warp-only reductions: the visit sum is one redux.sync add where every
//   count is whole and the total below 2^24 (every search's slab: the plain
//   version's float sum is then exact in any order), else the float
//   butterfly; the argmax is a redux.sync max over an order-preserving key,
//   then the first lane holding it (a ballot), as the plain version's
//   argmax; the winner's child index and visit count come from its owner in
//   one shuffle each, with no further load. The virtual-visit mark is a
//   store by the owner, which holds the count.
// - Off the chain: the pUCT numerator depends only on the parent's visit
//   count, so each block tabulates it once per launch (the same float32
//   operations: exact), and a level scores with the numerator of a
//   predicted count (the visit count of the edge just taken) while the sum
//   is reduced, redoing only the numerator's product if they differ (the
//   rest of the score does not depend on it); divisions are exact table
//   divisions (div_rn) where some edge of the node has a visit, IEEE ones
//   where an operand leaves div_rn's range; each level's Philox words are
//   computed while its loads are in flight.
// The backprop gives each lane one warp, a thread per level, and needs no
// batch-wide bound: two memory round trips for a path of up to 32 levels,
// then the value chain from registers (see backprop_kernel). Nothing here
// allocates: the wrapper passes every output.
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

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoEdge = 0x7fffffff;
// Entries of the per-launch tables (12 bytes each: 48 KB, the most a block
// takes without opting in).
constexpr int kTableMax = 4096;
// A visit sum whose terms are whole numbers in [0, 2^24) and whose total is
// below 2^24 is exact in float32 in any order.
constexpr unsigned kExact = 1u << 24;
// Warps per block: warp 0 descends one lane's tree, and all eight build the
// launch's tables (one entry a thread at N = 201), which one warp alone took
// ~2,700 cycles to build, longer than the root row's loads (PERF.md, kernel
// 2).
constexpr int kDescendWarps = 8;

}  // namespace

struct DescendArgs {
  int B, A, N, D, sim, table_n;
  float pb_c_base, pb_c_init, disc_sign, jitter_scale;
  uint32_t key0, key1;
};

__device__ __forceinline__ float pb_c_numerator(float p, const DescendArgs& args) {
  return (logf((p + args.pb_c_base + 1.f) / args.pb_c_base) + args.pb_c_init) * sqrtf(p);
}

// The same, for counts past the table: a call, so that the compiler cannot
// compute it alongside every table read.
__device__ __noinline__ float pb_c_numerator_call(float p, DescendArgs args) {
  return pb_c_numerator(p, args);
}

// The launch's shared tables: the pUCT numerator of parent visit count p,
// and 1 / b correctly rounded to double, for whole p, b in [0, n).
struct Tables {
  const float* num;
  const double* rcp;
  int n;
};

__device__ __forceinline__ float numerator(int p, const Tables& tab, const DescendArgs& args) {
  return p < tab.n ? tab.num[p] : pb_c_numerator_call((float)p, args);
}

// a / b correctly rounded, without the branch of the IEEE division's slow
// path, for b a whole number in [1, tab.n) (a visit count + 1, or at least
// 1), given as an int, and a zero or finite with |a| >= 2^-100:
// RN_double(a * RN_double(1 / b)), within 2^-52 of a / b, rounded once to
// float. An exact quotient a / b (b below 2^24) is never a float midpoint
// (its odd part would need 25 bits) and lies at least 2^-49 (relative) from
// every one, so that rounding is the correctly rounded quotient (as
// csrc/mcts_stream.cu). The table index comes straight from the count, with
// no float conversion on the chain. ok is cleared where `need` and the
// operands leave that range.
__device__ __forceinline__ float div_rn(float a, int b, bool need, const Tables& tab, bool& ok) {
  const bool in_table = (unsigned)(b - 1) < (unsigned)(tab.n - 1);
  const float m = fabsf(a);
  const bool in_range = (a == 0.f) | ((m >= 0x1p-100f) & (m <= 3.4028234e38f));
  ok &= !need | (in_table & in_range);
  return __double2float_rn((double)a * tab.rcp[in_table ? b : 1]);
}

// One edge of the current node, as the thread that owns it holds it.
struct Edge {
  int vis, child;
  float vsum, prior, reward;
};

// Per-launch values shared by every edge of the lane.
struct Level {
  float mn, inv_span;
  bool span_ok;
};

// The edge's pUCT score with numerator pb, with IEEE divisions: the plain
// version's float32 operations in its order.
__device__ __forceinline__ float score_ieee(const Edge& e, float pb, const Level& lv,
                                           const DescendArgs& args) {
  const float cvis = (float)e.vis;
  const bool visited = cvis > 0.f;
  const float cval = visited ? e.vsum / fmaxf(cvis, 1.f) : 0.f;
  const float q = e.reward + args.disc_sign * cval;
  const float qn = lv.span_ok ? (q - lv.mn) * lv.inv_span : q;
  return pb / (cvis + 1.f) * e.prior + (visited ? qn : 0.f);
}

// The same score in two parts: what does not depend on the numerator (the
// value term, and 1 / (cvis + 1) for div_rn), computed once a level, and
// finish(), which applies a numerator: RN(pb / (cvis + 1)) * prior + term.
// So a level that scores with a predicted numerator and learns the summed
// one redoes only finish(). An edge with no visits scores pb / (0 + 1) *
// prior + 0 = pb * prior + 0 exactly, so where no edge of the node has a
// visit (any_visits false, warp-uniform; deep in a tree most nodes) nothing
// is divided. ok is cleared where div_rn cannot stand in for the divisions.
struct Part {
  double rcp;  // RN_double(1 / (cvis + 1))
  float prior, term;
  bool ok;
};

__device__ __forceinline__ Part partial(const Edge& e, bool any_visits, const Level& lv,
                                        const DescendArgs& args, const Tables& tab) {
  if (!any_visits) return {1.0, e.prior, 0.f, true};
  bool ok = true;
  const bool visited = e.vis > 0;
  // fmaxf(cvis, 1) and cvis + 1 as whole numbers (counts in [0, 2^24): the
  // table's range, the IEEE division's outside it).
  const float vq = div_rn(e.vsum, max(e.vis, 1), visited, tab, ok);
  const float q = e.reward + args.disc_sign * (visited ? vq : 0.f);
  const float qn = lv.span_ok ? (q - lv.mn) * lv.inv_span : q;
  const bool in_table = (unsigned)e.vis < (unsigned)(tab.n - 1);
  return {tab.rcp[in_table ? e.vis + 1 : 1], e.prior, visited ? qn : 0.f, ok && in_table};
}

__device__ __forceinline__ float finish(const Part& pt, float pb) {
  return __double2float_rn((double)pb * pt.rcp) * pt.prior + pt.term;
}

// div_rn's range for the numerator itself (a dividend).
__device__ __forceinline__ bool dividend_ok(float a) {
  const float m = fabsf(a);
  return (a == 0.f) | ((m >= 0x1p-100f) & (m <= 3.4028234e38f));
}

// A key whose unsigned order is the float order of a score, -0 and +0 equal
// (as the plain version's argmax compares them), every real score (-inf
// included) above 0, the key of no edge and of a NaN score.
__device__ __forceinline__ uint32_t order_key(float s) {
  if (s != s) return 0u;
  const uint32_t u = __float_as_uint(s == 0.f ? 0.f : s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint32_t jitter_word(const DescendArgs& args, int b, int t, int a) {
  const uint4 r = philox4x32_10(
      make_uint4((uint32_t)b, (uint32_t)args.sim, (uint32_t)t, (uint32_t)(a >> 2)), args.key0,
      args.key1);
  const int j = a & 3;
  return j == 0 ? r.x : j == 1 ? r.y : j == 2 ? r.z : r.w;
}

// A thread's term of the visit sum's exactness test: the visit count where
// it is a whole number in [0, 2^24), else 2^24 (never exact).
__device__ __forceinline__ unsigned exact_term(int v) {
  return v >= 0 ? min((unsigned)v, kExact) : kExact;
}

// The plain version's pUCT numerator where the visit sum is not exact in
// float32 (off every search's path): the float sum of each thread's partial
// sum, in a butterfly, + 1 for an interior node.
__device__ __noinline__ float numerator_float(float part, bool interior, DescendArgs args) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(kFull, part, off);
  return pb_c_numerator(part + (interior ? 1.f : 0.f), args);
}

// kPlanar: [B, A, N] slabs, else node-major [B, N, A]. kMark: +1 visit on
// every edge taken (the visit slab is then written). kWide: A > 32, each
// level read in two passes; else every thread owns one action (a = its
// lane) and a level is one memory round trip.
template <bool kPlanar, bool kMark, bool kWide>
__global__ void __launch_bounds__(32 * kDescendWarps)
    descend_kernel(DescendArgs args, const int* __restrict__ depth_bound,
                   const int* __restrict__ child, const float* __restrict__ prior,
                   int* __restrict__ visit, const float* __restrict__ vsum,
                   const float* __restrict__ reward, const int* __restrict__ legal,
                   const float* __restrict__ min_value, const float* __restrict__ max_value,
                   int* __restrict__ out_parent, int* __restrict__ out_action,
                   int* __restrict__ out_depth, int* __restrict__ path_n,
                   int* __restrict__ path_a) {
  extern __shared__ double s_rcp[];  // [table_n], then the numerators [table_n]
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  const bool live = threadIdx.x < 32;  // warp 0: the lane's descent
  const int A = args.A, N = args.N, D = args.D;
  const size_t lane_base = (size_t)b * A * N;
  // Edge (node, action) of this lane.
  auto edge = [&](int node, int a) -> size_t {
    return lane_base + (kPlanar ? (size_t)a * N + node : (size_t)node * A + a);
  };
  auto load_edge = [&](size_t e) -> Edge {
    return {visit[e], child[e], vsum[e], prior[e], reward[e]};
  };

  // The root's edges and the lane's scalars first: nothing on their way
  // waits, and the tables below are built while they are in flight.
  const bool owns = !kWide && lane < A;  // kWide: every thread takes every 32nd action
  Edge r = {0, -1, 0.f, 0.f, 0.f};
  bool legal_a = false;
  float mn = 0.f, mx = 0.f;
  int bound = 0;
  if (live) {
    if (owns) {
      r = load_edge(edge(0, lane));
      legal_a = legal[(size_t)b * A + lane] != 0;
    }
    mn = min_value[b];
    mx = max_value[b];
    // The caller's bound on the descent length, capped at the tree's depth.
    bound = min(*depth_bound, D - 1);
  }
  // The pUCT numerator (log((p + base + 1) / base) + init) * sqrt(p) depends
  // only on the parent's visit count p, a whole number: tabulated once per
  // launch with the same float32 operations, so a table read is exact.
  float* s_num = reinterpret_cast<float*>(s_rcp + args.table_n);
#pragma unroll 2
  for (int p = threadIdx.x; p < args.table_n; p += 32 * kDescendWarps) {
    s_num[p] = pb_c_numerator((float)p, args);
    s_rcp[p] = p > 0 ? 1.0 / (double)p : 0.0;
  }
  __syncthreads();
  if (!live) return;  // the helper warps leave
  const Tables tab = {s_num, s_rcp, args.table_n};
  const Level lv = {mn, 1.f / fmaxf(mx - mn, 1e-30f), mx > mn};
  const bool jitter = args.jitter_scale > 0.f;
  int* pn = path_n + (size_t)b * D;
  int* pa = path_a + (size_t)b * D;

  // The parent's visit count p of the next node, predicted: in a tree whose
  // backups are complete (virtual visits included: a mark on an edge comes
  // with one below it or on the unexpanded edge) a node's edge visits sum to
  // the visit count of the edge into it minus one, and p adds one back. A
  // level scores with that guess while the visit sum is reduced, and redoes
  // the numerator's product (finish) only if the sum disagrees: the summed
  // p's result on any slab, the reduction off the chain on a consistent one.
  int spec_p = -1;
  float spec_pb = 0.f;
  int current = 0, depth = 0, parent = 0, action = 0, t = 0;
  bool active = true;
  for (; t < bound && active; ++t) {
    int a_win, next, w_vis, owner;
    if constexpr (!kWide) {
      // This level's jitter word, while the row's loads are in flight.
      const uint32_t word = jitter && owns ? jitter_word(args, b, t, lane) : 0u;
      // p: one integer redux where every count is whole and the total below
      // 2^24 (every search's slab), exactly the plain version's float sum.
      const int v = owns ? r.vis : 0;
      const unsigned sum = __reduce_add_sync(kFull, exact_term(v));
      const bool exact = sum < kExact;
      const int p = (int)sum + (current != 0 ? 1 : 0);
      const bool any_visits = __any_sync(kFull, v != 0);
      const Part pt = partial(r, any_visits, lv, args, tab);
      const bool parts_ok = __all_sync(kFull, pt.ok);
      float pb = spec_pb;
      float s = finish(pt, pb);
      if (p != spec_p || !exact) {  // warp-uniform
        pb = exact ? numerator(p, tab, args) : numerator_float((float)v, current != 0, args);
        s = finish(pt, pb);
      }
      if (!parts_ok || !dividend_ok(pb)) s = score_ieee(r, pb, lv, args);  // warp-uniform
      if (current == 0 && !legal_a) s = -INFINITY;
      if (jitter) s = s + (float)word * args.jitter_scale;
      // The argmax: the highest key, then the first lane holding it (lane
      // order is action order); action 0 if every score is NaN.
      const uint32_t key = owns ? order_key(s) : 0u;
      const uint32_t top = __reduce_max_sync(kFull, key);
      owner = top != 0u ? __ffs(__ballot_sync(kFull, key == top)) - 1 : 0;
      a_win = owner;
      next = __shfl_sync(kFull, r.child, owner);
      w_vis = __shfl_sync(kFull, r.vis, owner);
      // The virtual-visit mark, after this level's scores, by the thread
      // that read the count (so a later read of it on this lane's path, in
      // this thread, sees it): a store, no atomics (the warp owns its lane's
      // slab).
      if (kMark && lane == owner) visit[edge(current, a_win)] = r.vis + 1;
      // The next level's row, first (after the mark: a cycle in a slab that is
      // not a tree may lead back to this node, and this thread reads it).
      if (next >= 0 && owns) r = load_edge(edge(next, lane));
    } else {
      // Pass 1: the visit count, as above.
      unsigned x = 0;
      float part = 0.f;
      for (int a = lane; a < A; a += 32) {
        const int v = visit[edge(current, a)];
        x = min(x + exact_term(v), kExact);
        part += (float)v;
      }
      const unsigned sum = __reduce_add_sync(kFull, x);
      const float pb = sum < kExact ? numerator((int)sum + (current != 0 ? 1 : 0), tab, args)
                                    : numerator_float(part, current != 0, args);
      // Pass 2: each thread's best action (IEEE divisions: this path is off
      // every game's), then the warp's: the highest key, then the lowest
      // action holding it.
      uint32_t best_key = 0u;
      int best_a = kNoEdge, best_child = -1, best_vis = 0;
      for (int a = lane; a < A; a += 32) {
        const Edge e = load_edge(edge(current, a));
        float s = score_ieee(e, pb, lv, args);
        if (current == 0 && legal[(size_t)b * A + a] == 0) s = -INFINITY;
        if (jitter) s = s + (float)jitter_word(args, b, t, a) * args.jitter_scale;
        const uint32_t key = order_key(s);
        if (key > best_key) {
          best_key = key;
          best_a = a;
          best_child = e.child;
          best_vis = e.vis;
        }
      }
      const uint32_t top = __reduce_max_sync(kFull, best_key);
      if (top != 0u) {
        a_win = (int)__reduce_min_sync(kFull, best_key == top ? (uint32_t)best_a : 0xffffffffu);
        owner = a_win & 31;
        next = __shfl_sync(kFull, best_child, owner);
        w_vis = __shfl_sync(kFull, best_vis, owner);
        if (kMark && lane == owner) visit[edge(current, a_win)] = best_vis + 1;
      } else {  // every score NaN: action 0, whose thread is lane 0
        a_win = owner = 0;
        next = child[edge(current, 0)];
        w_vis = visit[edge(current, 0)];
        if (kMark && lane == 0) visit[edge(current, 0)] = w_vis + 1;
      }
    }
    if (lane == 0) pa[t] = a_win;
    if (next < 0) {
      parent = current;
      action = a_win;
      active = false;
    } else {
      current = next;
      depth += 1;
      if (lane == 0) pn[depth] = current;
      if ((unsigned)w_vis < (unsigned)tab.n) {
        spec_p = w_vis;
        spec_pb = tab.num[w_vis];
      } else {
        spec_p = -1;
      }
    }
  }
  // Levels the lane did not reach keep the padding: node -1 past the last
  // recorded node, action 0 past the last recorded level.
  for (int i = lane; i < D; i += 32) {
    if (i == 0)
      pn[0] = 0;  // the root at depth 0
    else if (i > depth)
      pn[i] = -1;
    if (i >= t) pa[i] = 0;
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

// A load kept in program order: volatile, so the compiler does not sink it
// below the branch on another load's value that follows (a round trip's
// loads must all be in flight before the first of them is used).
__device__ __forceinline__ int load_now(const int* p) {
  int v;
  asm volatile("ld.global.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float load_now(const float* p) {
  float v;
  asm volatile("ld.global.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// An integer key of a MinMax stat whose signed order is the order fminf and
// fmaxf give floats on this card, -0 below +0 (stats are never NaN), so a
// redux.sync min or max of keys is the serial fold's result in any order.
__device__ __forceinline__ int minmax_key(float x) {
  const int i = __float_as_int(x);
  return i ^ ((i >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float from_minmax_key(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// Lanes a block of the backprop, one warp each: four measured 0-5% faster
// than one and 6-13% faster than eight (PERF.md, kernel 3).
constexpr int kBackpropLanes = 4;

// One chunk of a lane's path: entries lo .. hi - 1 (the edges of levels
// lo + 1 .. hi), thread j owning entry lo + j and holding its edge's offset
// e, old visit ev, old value sum es and reward r. Every thread runs the
// value chain over the chunk, leaf end first, and the owner of each entry
// keeps that level's delta; value and t_rev carry on to the next chunk. The
// chain is the plain version's, each operation rounded on its own. kSerial
// (a chunk that repeats an edge): each owner in turn rereads its edge,
// which a deeper level of the chunk may have written, and writes it back
// before the next level reads, as a serial walk does. Returns the owner's
// delta.
template <bool kSerial>
__device__ __forceinline__ float chain_chunk(const BackpropArgs& args, int lo, int hi, int j,
                                             float r, size_t e, int& ev, float& es,
                                             float& value, int& t_rev, int* visit,
                                             float* vsum) {
  float mine = 0.f;
  for (int k = hi - 1; k >= lo; --k) {
    const int owner = k - lo;
    const float nrew = __shfl_sync(kFull, r, owner);
    // node_to_play == the leaf's player <=> t_rev even (two players)
    const float sgn = (args.num_players == 1 || (t_rev & 1) == 0) ? 1.f : -1.f;
    const float delta = value * sgn;
    if (j == owner) {
      mine = delta;
      if (kSerial) {
        ev = visit[e];
        es = vsum[e];
        vsum[e] = es + delta;
        if (!args.pre_marked) visit[e] = ev + 1;
      }
    }
    if (kSerial) __syncwarp();
    if (args.num_players == 1)
      value = nrew + args.discount * value;
    else
      value = -sgn * nrew + args.discount * value;
    ++t_rev;
  }
  return mine;
}

// The backprop, one warp per lane. Only the value chain is serial: it needs
// each level's reward and about two flops a level, so it runs from
// registers (a shuffle a level) once the path's edges have arrived. Every
// memory access is off that chain:
// - round trip 1: the lane's leaf depth (one broadcast request) and the
//   first 32 path entries, none waiting on another (ptxas moves the other
//   scalars' loads past a leafless lane's exit, beside round trip 2, which
//   needs them no sooner);
// - round trip 2: each live entry's visit, value sum and reward, issued
//   together by their owners;
// - then the chain, each level's new value sum, node value (IEEE division)
//   and MinMax stat on its owner in parallel, the min/max as one redux.sync
//   each over order-preserving keys (fminf and fmaxf order -0 below +0 in
//   either operand order on this card, so any order gives the serial
//   fold's bits), and the stores.
// Deeper paths run in chunks of 32 entries from the leaf end, each chunk's
// stores before the next chunk's loads (a __syncwarp orders them), so a
// level reads what any deeper chunk wrote. On a search's tree a lane's edges
// are distinct; a chunk that repeats an edge (found by __match_any_sync over
// its offsets) walks its levels one after another instead.
__global__ void __launch_bounds__(32 * kBackpropLanes)
    backprop_kernel(BackpropArgs args, const int* __restrict__ path_n,
                    const int* __restrict__ path_a, const int* __restrict__ leaf_depth,
                    const float* __restrict__ leaf_value, const float* __restrict__ reward,
                    const float* __restrict__ root_reward, int* __restrict__ visit,
                    float* __restrict__ vsum, int* __restrict__ root_visit,
                    float* __restrict__ root_vsum, float* __restrict__ min_value,
                    float* __restrict__ max_value) {
  const int b = blockIdx.x * kBackpropLanes + (threadIdx.x >> 5);
  if (b >= args.B) return;  // whole warps
  const int j = threadIdx.x & 31;
  const int* pn = path_n + (size_t)b * args.D;
  const int* pa = path_a + (size_t)b * args.D;
  // Round trip 1.
  const int L = load_now(leaf_depth + b);
  float value = load_now(leaf_value + b);
  const int rvis = load_now(root_visit + b);
  const float rvsum = load_now(root_vsum + b);
  const float rrew = load_now(root_reward + b);
  const float mn = load_now(min_value + b), mx = load_now(max_value + b);
  int n0 = 0, a0 = 0;
  if (j < args.D) {
    n0 = load_now(pn + j);
    a0 = load_now(pa + j);
  }
  if (L < 0) return;  // nothing to back up: every output keeps its value
  const size_t base = (size_t)b * args.NA;
  float lmn = INFINITY, lmx = -INFINITY;  // this thread's stats
  int t_rev = 0;                          // levels folded so far
  for (int c = (L - 1) >> 5; c >= 0; --c) {
    const int lo = c << 5, hi = min(L, lo + 32), i = lo + j;
    const bool live = i < hi;
    int n = n0, a = a0;
    if (c > 0) {  // entries past the first 32: loaded once L is known
      n = live ? pn[i] : 0;
      a = live ? pa[i] : 0;
    }
    const int off = n * args.stride_n + a * args.stride_a;
    const size_t e = base + (size_t)off;
    // Round trip 2.
    int ev = 0;
    float es = 0.f, r = 0.f;
    if (live) {
      ev = visit[e];
      es = vsum[e];
      r = reward[e];
    }
    const unsigned same = __match_any_sync(kFull, live ? off : -1 - j);
    const bool repeat = __any_sync(kFull, live && __popc(same) > 1);
    const float delta =
        repeat ? chain_chunk<true>(args, lo, hi, j, r, e, ev, es, value, t_rev, visit, vsum)
               : chain_chunk<false>(args, lo, hi, j, r, e, ev, es, value, t_rev, visit, vsum);
    if (live) {
      const float es_new = es + delta;
      if (!repeat) {
        vsum[e] = es_new;
        if (!args.pre_marked) visit[e] = ev + 1;
      }
      // Pre-marked: the descent already counted this visit, so the count
      // read is the new one.
      const float ev_old = (float)ev;
      const float nval = es_new / (args.pre_marked ? fmaxf(ev_old, 1.f) : ev_old + 1.f);
      const float stat = r + args.disc_sign * nval;
      lmn = fminf(lmn, stat);
      lmx = fmaxf(lmx, stat);
    }
    __syncwarp();  // this chunk's stores before a shallower chunk's loads
  }
  // The root keeps explicit scalars (t = 0, t_rev = L).
  const float sgn = (args.num_players == 1 || (L & 1) == 0) ? 1.f : -1.f;
  const float rvsum_new = rvsum + value * sgn;
  const int rvis_new = args.pre_marked ? rvis : rvis + 1;
  const float rstat = rrew + args.disc_sign * (rvsum_new / (float)max(rvis_new, 1));
  lmn = from_minmax_key(__reduce_min_sync(kFull, minmax_key(lmn)));
  lmx = from_minmax_key(__reduce_max_sync(kFull, minmax_key(lmx)));
  if (j == 0) {
    root_vsum[b] = rvsum_new;
    if (!args.pre_marked) root_visit[b] = rvis_new;
    min_value[b] = fminf(fminf(mn, lmn), rstat);
    max_value[b] = fmaxf(fmaxf(mx, lmx), rstat);
  }
}

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
  // Parent visit counts reach N + 1 on a search's tree (N - 1 simulations'
  // visits and an interior node's expansion, K marks of a round within them).
  args.table_n = N + 2 < kTableMax ? N + 2 : kTableMax;
  args.pb_c_base = pb_c_base;
  args.pb_c_init = pb_c_init;
  args.disc_sign = disc_sign;
  args.jitter_scale = jitter_scale;
  args.key0 = (uint32_t)(seed & 0xffffffffull);
  args.key1 = (uint32_t)(seed >> 32);
  const int blocks = B;  // one lane a block
  const int threads = 32 * kDescendWarps;
  const size_t smem = (size_t)args.table_n * (sizeof(double) + sizeof(float));
  cudaStream_t s = (cudaStream_t)stream;
#define MCTS_DESCEND(P, M, W)                                                                   \
  descend_kernel<P, M, W><<<blocks, threads, smem, s>>>(args, depth_bound, child, prior, visit, \
                                                        vsum, reward, legal, min_value,        \
                                                        max_value, out_parent, out_action,     \
                                                        out_depth, path_n, path_a)
  const bool wide = A > 32;
  if (!planar && wide)
    MCTS_DESCEND(false, false, true);
  else if (!planar)
    MCTS_DESCEND(false, false, false);
  else if (mark && wide)
    MCTS_DESCEND(true, true, true);
  else if (mark)
    MCTS_DESCEND(true, true, false);
  else if (wide)
    MCTS_DESCEND(true, false, true);
  else
    MCTS_DESCEND(true, false, false);
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
  const int blocks = (B + kBackpropLanes - 1) / kBackpropLanes;
  backprop_kernel<<<blocks, 32 * kBackpropLanes, 0, (cudaStream_t)stream>>>(
      args, path_n, path_a, leaf_depth, leaf_value, reward, root_reward, visit, vsum, root_visit,
      root_vsum, min_value, max_value);
  return (int)cudaGetLastError();
}
