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
// A = 121 columns (2.4 KB) per lane and level, 64 lanes a few hundred levels
// deep, a few megabytes per launch; an update touches two floats per live
// (lane, level). What bounds the descent is latency: each level is a
// dependent chain (the row's loads, the visit sum, the scores, the argmax,
// then the chosen child decides the next row), so a launch costs about its
// deepest lane's chain, levels times the latency of one level. The update
// is two round trips a thread (its slot's words, then its edge's), so it
// costs a launch and those two round trips; its floor, the same launch
// with nothing to update, is most of it (PERF.md, kernel 5).
//
// What the descent's design does about that: it keeps one level's chain to
// one memory round trip and little else.
// - One warp per lane (tree), one lane a block, so 64 lanes take 64 SMs
//   (four lanes a block measured slower: the chain's latency, not
//   occupancy, decides; PERF.md, kernel 4). Each thread owns four
//   consecutive action columns of every 128-column chunk and loads each of
//   the five planes as one float4 (rows are 16-byte aligned: pack_tree pads
//   A to a multiple of 128, S_PLANES is 8; the wrapper checks). On a row of
//   one chunk (A_pad = 128: pack_tree's rows for A <= 128, every game of
//   the port that takes this route) the plane strides are constants and all
//   loads of a level are issued before any is used, so the child index of
//   the winner comes out of registers, not from a load that waits on the
//   score. Wider rows are read in two passes over their chunks.
// - Warp-only reductions, no shared memory and no __syncthreads on the
//   level's path: the visit sum is one redux.sync add where every thread's
//   partial is a whole number below 2^24, as the search's counts are (their
//   float sum is exact in any order), else a float butterfly of shuffles,
//   truncated once as the plain version truncates its float sum (a redux
//   alone, truncating each partial, would take 2.5 + 3.5 for 5); a thread
//   reduces its own four columns as a tree; the argmax is a redux.sync max
//   over an order-preserving key of each thread's best, then the first
//   index holding it (at one chunk a ballot, since lane order is column
//   order; else a redux.sync min), as the plain version's argmax; the
//   winner's child, then its reward, visit and vsum, come from its owning
//   thread in one shuffle each.
// - Scoring without the IEEE division's branches: an unvisited column's
//   pb / (0 + 1) is pb exactly and it adds no value, so a column slot
//   divides only where some lane holds a visited column (a warp vote; deep
//   in a tree most slots hold none), and it divides by a shared table of
//   1 / b in double (div_rn, exact: see there), with the IEEE division for
//   the warp where an operand leaves div_rn's range.
// - Off the chain: the pUCT numerator (log((p + base + 1) / base) + init) *
//   sqrt(p) depends only on the parent's visit count p, an integer below
//   N1, so each block tabulates it once per launch in shared memory with the
//   same float32 operations (the plain version's table). On a one-chunk row
//   a level scores with the numerator of a predicted p (the visit count of
//   the edge just taken, which a consistent tree makes equal) while the
//   visit sum is reduced, and scores again only if the sum disagrees (one
//   branch: a fractional sum rescores too): the result is always that of
//   the summed p, the reduction off the chain on real trees. The root's
//   legal mask is read into a register bitmask once; each level's Philox
//   words (one call per thread and chunk: four columns) are computed while
//   that level's loads are in flight; lanes 0-3 write the level's record
//   with one store each.
// The chain is sensitive to code layout: equivalent rewrites of this
// kernel's source measured up to 12% slower per level (PERF.md, kernel 4);
// time a change with tools/stream_descend_cost.py before keeping it.
//
// The update needs neither the TPU kernel's upfront SMEM offsets nor its
// double-buffered row read-modify-writes: one thread per (level, lane) adds
// to its own edge. Within one call every live target is distinct (a descent
// never repeats an edge), so no atomics are needed; masked levels, aimed at
// the dummy row by backprop_stream, write nothing. What the design does
// about the round trips: each thread issues all five reads it needs before
// it knows whether its slot is live (the bound, mask, node, action and
// delta, all in bounds) together, so a live slot's edge read is the second
// round trip, not the third; one-warp blocks spread gomoku's [401, 64]
// slots over every SM.
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
constexpr int kChunk = 128;       // columns per chunk: 32 threads x 4
constexpr int kTable = 2048;      // entries of the shared tables (24 KB)
constexpr unsigned kFull = 0xffffffffu;
// The edge update's blocks: one warp, so that gomoku's 25,664 slots spread
// over every SM (802 blocks; 256-thread blocks filled 101 SMs and took
// 19-24% longer than 64-thread ones, which took 5-20% longer than one
// warp: PERF.md, kernel 5), one slot a thread (four slots a thread,
// grid-stride, took 40% longer).
constexpr int kUpdateThreads = 32;

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
  int B, N1, A, A_pad, D, sim;
  float pb_c_base, pb_c_init, disc_sign, jitter_scale;
  uint32_t key0, key1;
};

__device__ __forceinline__ float pb_c_numerator(float p, const DescendArgs& args) {
  return (logf((p + args.pb_c_base + 1.f) / args.pb_c_base) + args.pb_c_init) * sqrtf(p);
}

// The same, for counts past the table: a call, so that the compiler cannot
// compute it alongside every table read.
__device__ __noinline__ float pb_c_numerator_call(int p, DescendArgs args) {
  return pb_c_numerator((float)p, args);
}

// A thread's four columns of one row: the five planes.
struct Cols {
  float4 vis, vsum, rew, prior, child;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// The five planes of four columns at p, planes `stride` floats apart.
__device__ __forceinline__ Cols load_cols(const float* p, int stride) {
  Cols c;
  // In the order the level uses them: the child index last.
  c.vis = ld4(p + kVisit * stride);
  c.prior = ld4(p + kPrior * stride);
  c.vsum = ld4(p + kVsum * stride);
  c.rew = ld4(p + kReward * stride);
  c.child = ld4(p + kChild * stride);
  return c;
}

__device__ __forceinline__ float at(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t at(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The sum of the visits of a thread's columns below A (integers: exact).
__device__ __forceinline__ float visit_part(const float4& vis, int col, int A) {
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (col + j < A) part += at(vis, j);
  return part;
}

// A candidate edge: its score and index. better() takes the higher score,
// then the lower index (first-index argmax over equal scores, as the plain
// version's argmax). A NaN score never wins: such a column, or one past A,
// is (-inf, kNoEdge), which every real candidate beats.
struct Cand {
  float score;
  int a;
};

constexpr int kNoEdge = 0x7fffffff;

__device__ __forceinline__ bool better(const Cand& x, const Cand& y) {
  return x.score > y.score || (x.score == y.score && x.a < y.a);
}

__device__ __forceinline__ Cand pick(const Cand& x, const Cand& y) {
  return better(y, x) ? y : x;
}

// Per-level values shared by every column of the row.
struct Level {
  float mn, inv_span;
  bool span_ok, at_root;
};

// The launch's shared table of 1 / b correctly rounded to double, for
// whole b in [1, n).
struct Tables {
  const double* rcp;
  int n;
};

// a / b correctly rounded, without the branch of the IEEE division's slow
// path, for b a whole number in [1, tab.n) (a visit count + 1, or at
// least 1) and a zero or finite with |a| >= 2^-100: RN_double(a * RN_double(1
// / b)), within 2^-52 of a / b, rounded once to float. An exact quotient a /
// b (b below 2^24) is never a float midpoint (its odd part would need 25
// bits) and lies at least 2^-49 (relative) from every one, so that rounding
// is the correctly rounded quotient. ok is cleared where `need` and the
// operands leave that range.
__device__ __forceinline__ float div_rn(float a, float b, bool need, const Tables& tab,
                                        bool& ok) {
  const int bi = (int)b;
  const bool whole = (b >= 1.f) & ((float)bi == b) & (bi < tab.n);
  const float m = fabsf(a);
  const bool in_range = (a == 0.f) | ((m >= 0x1p-100f) & (m <= 3.4028234e38f));
  ok &= !need | (whole & in_range);
  return __double2float_rn((double)a * tab.rcp[whole ? bi : 1]);
}

// Score a thread's four columns (the plain version's float32 operations in
// its order) with pUCT numerator pb, and return their best, as a tree. An
// unvisited column's pb / (0 + 1) is pb exactly and it adds no value, so a
// column slot divides only where some lane of the warp holds a visited
// column (deep in a tree, most slots of a row hold none): with div_rn, or
// with IEEE divisions where ok came back false (kIeee, warp-uniform, off
// real data's path). Every lane takes the same path.
template <bool kIeee>
__device__ __forceinline__ Cand score_cols(const Cols& c, int col, uint32_t legal4,
                                           const uint4& bits, float pb, const Level& lv,
                                           const DescendArgs& args, const Tables& tab,
                                           bool& ok) {
  Cand cand[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float cvis = at(c.vis, j), prior = at(c.prior, j);
    const bool visited = cvis > 0.f;
    float score = pb * prior + 0.f;
    if (__any_sync(kFull, visited)) {
      const float vq = kIeee ? at(c.vsum, j) / fmaxf(cvis, 1.f)
                             : div_rn(at(c.vsum, j), fmaxf(cvis, 1.f), visited, tab, ok);
      const float cval = visited ? vq : 0.f;
      const float pq = kIeee ? pb / (cvis + 1.f) : div_rn(pb, cvis + 1.f, true, tab, ok);
      const float q = at(c.rew, j) + args.disc_sign * cval;
      const float qn = lv.span_ok ? (q - lv.mn) * lv.inv_span : q;
      score = pq * prior + (visited ? qn : 0.f);
    }
    if (lv.at_root && ((legal4 >> j) & 1u) == 0) score = -INFINITY;
    if (args.jitter_scale > 0.f) score = score + (float)at(bits, j) * args.jitter_scale;
    const bool real = col + j < args.A && score == score;
    cand[j] = {real ? score : -INFINITY, real ? col + j : kNoEdge};
  }
  return pick(pick(cand[0], cand[1]), pick(cand[2], cand[3]));
}

// Chunk k's columns start at col0 + 128 k.
template <int NC>
__device__ __forceinline__ void score_chunks(const Cols (&cols)[NC], int col0, uint32_t legal_bits,
                                             const uint4 (&bits)[NC], float pb, const Level& lv,
                                             const DescendArgs& args, const Tables& tab,
                                             Cand (&cand)[NC]) {
  bool ok = true;
#pragma unroll
  for (int k = 0; k < NC; ++k)
    cand[k] = score_cols<false>(cols[k], col0 + k * kChunk, legal_bits >> (4 * k), bits[k], pb,
                                lv, args, tab, ok);
  if (!__all_sync(kFull, ok)) {
#pragma unroll
    for (int k = 0; k < NC; ++k)
      cand[k] = score_cols<true>(cols[k], col0 + k * kChunk, legal_bits >> (4 * k), bits[k],
                                 pb, lv, args, tab, ok);
  }
}

// visit(node) from each thread's partial sum of its edge visits: their sum,
// +1 for an interior node's expansion, truncated once, as the plain version
// truncates its float32 sum. visit_count_whole is one integer redux, exact
// where every partial is whole and below 2^24 (every slab the search
// builds), which `exact` reports (warp-uniform), beside it.
// visit_count_float is a butterfly of shuffles, equal to the plain
// version's sum wherever every partial sum is a float (halves, say).
__device__ __forceinline__ int visit_count_whole(float part, bool interior, bool& exact) {
  const unsigned whole = __float2uint_rz(part);  // saturates; NaN gives 0
  exact = __all_sync(kFull, whole < (1u << 24) && (float)whole == part);
  return (int)__reduce_add_sync(kFull, whole) + (interior ? 1 : 0);
}

__device__ __noinline__ int visit_count_float(float part, bool interior) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) part += __shfl_xor_sync(kFull, part, m);
  return (int)(part + (interior ? 1.f : 0.f));
}

// What the descent records of the edge it takes.
struct Stats {
  float reward, visit, vsum, child;
};

// The stats of column a if it is one of this thread's four at col.
__device__ __forceinline__ void take_stats(const Cols& c, int col, int a, Stats& st) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (a == col + j) st = {at(c.rew, j), at(c.vis, j), at(c.vsum, j), at(c.child, j)};
}

// A key whose unsigned order is the float order of a candidate's score,
// -0 and +0 equal (as better() compares them), no edge below every real
// candidate (-inf included).
__device__ __forceinline__ uint32_t order_key(const Cand& c) {
  if (c.a == kNoEdge) return 0u;
  const uint32_t u = __float_as_uint(c.score == 0.f ? 0.f : c.score);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint4 jitter_words(const DescendArgs& args, int b, int t, int col) {
  return philox4x32_10(
      make_uint4((uint32_t)b, (uint32_t)args.sim, (uint32_t)t, (uint32_t)(col >> 2)),
      args.key0, args.key1);
}

// NC = 1: A_pad is 128 (pack_tree's rows for A <= 128), the row held in
// registers with constant plane strides, one round trip a level. NC = 0:
// any width, each level's row read in two passes over its chunks.
template <int NC>
__global__ void __launch_bounds__(32)
    descend_stream_kernel(DescendArgs args, const int* __restrict__ depth_bound,
                          const float* __restrict__ edges, const int* __restrict__ legal,
                          const float* __restrict__ min_value,
                          const float* __restrict__ max_value, int* __restrict__ out_parent,
                          int* __restrict__ out_action, int* __restrict__ out_depth,
                          int* __restrict__ path_n, int* __restrict__ path_a,
                          float* __restrict__ path_r, float* __restrict__ path_v,
                          float* __restrict__ path_s) {
  __shared__ float s_num[kTable];
  __shared__ double s_rcp[kTable];
  const int table_n = min(args.N1 + 1, kTable);
  for (int p = threadIdx.x; p < table_n; p += blockDim.x) {
    s_num[p] = pb_c_numerator((float)p, args);
    s_rcp[p] = p > 0 ? 1.0 / (double)p : 0.0;
  }
  __syncthreads();
  const Tables tab = {s_rcp, table_n};
  auto numerator = [&](int p) {
    if (p < table_n) return s_num[p];
    return pb_c_numerator_call(p, args);
  };

  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int B = args.B, A = args.A, D = args.D;
  const int A_pad = NC > 0 ? NC * kChunk : args.A_pad;
  const bool jitter = args.jitter_scale > 0.f;

  Level lv;
  lv.mn = min_value[b];
  const float mx = max_value[b];
  lv.span_ok = mx > lv.mn;
  lv.inv_span = 1.f / fmaxf(mx - lv.mn, 1e-30f);
  // The caller's bound on the descent length, capped at the tree's depth.
  const int bound = min(*depth_bound, D - 1);
  const float* lane_rows = edges + (size_t)b * args.N1 * kPlanes * A_pad;
  const float* lane_cols = lane_rows + lane * 4;  // this thread's columns of row 0
  const int* lane_legal = legal + (size_t)b * A;
  // The level's record: lanes 0-3 store path_a, path_r, path_v, path_s.
  float* const record = (lane == 0   ? reinterpret_cast<float*>(path_a)
                         : lane == 1 ? path_r
                         : lane == 2 ? path_v
                                     : path_s) + b;
  // The root's legal mask, bit 4k + j for column 128k + 4 lane + j.
  uint32_t legal_bits = 0;
#pragma unroll
  for (int k = 0; k < NC; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int a = k * kChunk + lane * 4 + j;
      if (a < A && lane_legal[a] != 0) legal_bits |= 1u << (4 * k + j);
    }
  if (lane == 0) path_n[b] = 0;  // the root at depth 0

  // The parent's visit count p of the next row, predicted: in a tree whose
  // backups are complete a child's visits sum to its edge's visit count
  // minus one, so p is the visit count of the edge just taken. The level
  // scores with that guess while the visit sum is reduced, and scores again
  // if the sum disagrees: the summed p's result on any slab, one pass on a
  // consistent one.
  int spec_p = -1;
  float spec_pb = 0.f;
  int current = 0, depth = 0, parent = 0, action = 0, t = 0;
  bool active = true;
  for (; t < bound && active; ++t) {
    const float* row = lane_rows + (size_t)current * kPlanes * A_pad;
    lv.at_root = t == 0;
    Cand best = {-INFINITY, kNoEdge};
    Stats st = {0.f, 0.f, 0.f, -1.f};
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    Cols cols[NC > 0 ? NC : 1];
    if constexpr (NC > 0) {
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const float* p = lane_cols + (size_t)current * kPlanes * A_pad + k * kChunk;
        cols[k] = load_cols(p, A_pad);
      }
      uint4 bits[NC];
#pragma unroll
      for (int k = 0; k < NC; ++k)
        bits[k] = jitter ? jitter_words(args, b, t, k * kChunk + lane * 4) : make_uint4(0, 0, 0, 0);
      float part = 0.f;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int col = k * kChunk + lane * 4;
        if (col < A) part += visit_part(cols[k].vis, col, A);
      }
      bool exact;
      int p = visit_count_whole(part, t > 0, exact);
      Cand cand[NC];
      score_chunks<NC>(cols, lane * 4, legal_bits, bits, spec_pb, lv, args, tab, cand);
      if (p != spec_p || !exact) {  // warp-uniform
        if (!exact) p = visit_count_float(part, t > 0);
        score_chunks<NC>(cols, lane * 4, legal_bits, bits, numerator(p), lv, args, tab, cand);
      }
#pragma unroll
      for (int k = 0; k < NC; ++k) best = pick(best, cand[k]);
    } else {
      float part = 0.f;
      for (int col = lane * 4; col < A; col += kChunk)
        part += visit_part(ld4(row + kVisit * A_pad + col), col, A);
      bool exact;
      int p = visit_count_whole(part, t > 0, exact);
      if (!exact) p = visit_count_float(part, t > 0);
      const float pb = numerator(p);
      // Every lane takes every chunk (the warp votes inside score_chunks).
      for (int base = 0; base < A; base += kChunk) {
        const int col = base + lane * 4;
        Cols one[1] = {col < A ? load_cols(row + col, A_pad) : Cols{zero, zero, zero, zero, zero}};
        uint32_t legal4 = 0;
        if (t == 0)
          for (int j = 0; j < 4; ++j)
            if (col + j < A && lane_legal[col + j] != 0) legal4 |= 1u << j;
        const uint4 bits[1] = {jitter ? jitter_words(args, b, t, col) : make_uint4(0, 0, 0, 0)};
        Cand c[1];
        score_chunks<1>(one, col, legal4, bits, pb, lv, args, tab, c);
        if (better(c[0], best)) {
          best = c[0];
          take_stats(one[0], col, c[0].a, st);
        }
      }
    }

    // The argmax over the warp: the highest score, then the lowest index.
    const uint32_t key = order_key(best);
    const uint32_t top = __reduce_max_sync(kFull, key);
    if constexpr (NC > 0) {  // only the winner's owner needs them: off the reduction's path
#pragma unroll
      for (int k = 0; k < NC; ++k) take_stats(cols[k], k * kChunk + lane * 4, best.a, st);
    }
    int owner, a_win;
    if constexpr (NC == 1) {
      // Lane order is column order: the first lane holding the top wins.
      owner = __ffs(__ballot_sync(kFull, key == top)) - 1;
      a_win = __shfl_sync(kFull, best.a, owner);
    } else {
      a_win = (int)__reduce_min_sync(kFull, key == top ? (uint32_t)best.a : 0xffffffffu);
      owner = (a_win & (kChunk - 1)) >> 2;
    }
    float w_child = __shfl_sync(kFull, st.child, owner);  // the next row's, first
    float w_rew = __shfl_sync(kFull, st.reward, owner);
    float w_vis = __shfl_sync(kFull, st.visit, owner);
    float w_vsum = __shfl_sync(kFull, st.vsum, owner);
    if (top == 0u) {  // only if every score is NaN
      a_win = 0;
      w_rew = row[kReward * A_pad];
      w_vis = row[kVisit * A_pad];
      w_vsum = row[kVsum * A_pad];
      w_child = row[kChild * A_pad];
    }
    const int child = (int)w_child;

    // The level's record, one store each by lanes 0-3 (and 4 for the node).
    const float rec = lane == 0 ? __int_as_float(a_win) : lane == 1 ? w_rew : lane == 2 ? w_vis
                                                                                  : w_vsum;
    if (lane < 4) record[(size_t)t * B] = rec;
    if (child < 0) {
      parent = current;
      action = a_win;
      active = false;
    } else {
      current = child;
      depth += 1;
      if (lane == 4) path_n[(size_t)depth * B + b] = current;
      spec_p = (int)w_vis;
      spec_pb = numerator(spec_p);
    }
  }
  // Levels the lane did not reach keep the padding: node -1 past the last
  // recorded node, action and stats 0 past the last recorded level.
  for (int i = lane; i < D; i += 32) {
    const size_t k = (size_t)i * B + b;
    if (i > depth) path_n[k] = -1;
    if (i >= t) {
      path_a[k] = 0;
      path_r[k] = 0.f;
      path_v[k] = 0.f;
      path_s[k] = 0.f;
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

// The edge update, a thread per (level, lane) slot. Every read a slot needs
// before it knows whether it is live is in bounds (the bound, its mask,
// node, action and delta), so all five are issued together: round trip 1.
// Only then does the slot decide; a live one reads its edge's visit and
// value sum (round trip 2) and writes both back.
__global__ void __launch_bounds__(kUpdateThreads)
    update_edges_kernel(int B, int N1, int A_pad, int D, const int* __restrict__ bound,
                        float* __restrict__ edges, const int* __restrict__ path_n,
                        const int* __restrict__ path_a, const float* __restrict__ delta,
                        const float* __restrict__ mask) {
  const int i = blockIdx.x * kUpdateThreads + threadIdx.x;
  const bool slot = i < D * B;
  const int top = load_now(bound);
  float m = 0.f, d = 0.f;
  int n = 0, a = 0;
  if (slot) {
    m = load_now(mask + i);
    n = load_now(path_n + i);
    a = load_now(path_a + i);
    d = load_now(delta + i);
  }
  const int t = i / B, b = i - t * B;
  if (slot && t < top && m != 0.f) {
    float* row = edges + ((size_t)b * N1 + n) * kPlanes * A_pad;
    const float v = row[kVisit * A_pad + a], vs = row[kVsum * A_pad + a];
    row[kVisit * A_pad + a] = v + m;
    row[kVsum * A_pad + a] = vs + d;
  }
}

}  // namespace

extern "C" const char* mcts_stream_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Descend B packed trees on `stream`, one warp per lane. Device pointers
// throughout; depth_bound points at one int on the device. The slab's rows
// must be 16-byte aligned (edges aligned, A_pad a multiple of 4; the wrapper
// checks). Returns a cudaError_t.
extern "C" int mcts_stream_descend(const int* depth_bound, const float* edges, const int* legal,
                                   const float* min_value, const float* max_value,
                                   int* out_parent, int* out_action, int* out_depth,
                                   int* path_n, int* path_a, float* path_r, float* path_v,
                                   float* path_s, int B, int N1, int A, int A_pad, int D,
                                   int sim, float pb_c_base, float pb_c_init, float disc_sign,
                                   float jitter_scale, unsigned long long seed, void* stream) {
  if (B <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(edges) & 15) != 0 || A_pad % 4 != 0 || A <= 0 || A > A_pad)
    return (int)cudaErrorInvalidValue;
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
  cudaStream_t s = (cudaStream_t)stream;
#define DESCEND_ARGS                                                                        \
  args, depth_bound, edges, legal, min_value, max_value, out_parent, out_action, out_depth, \
      path_n, path_a, path_r, path_v, path_s
  if (A_pad == kChunk) descend_stream_kernel<1><<<B, 32, 0, s>>>(DESCEND_ARGS);
  else descend_stream_kernel<0><<<B, 32, 0, s>>>(DESCEND_ARGS);
#undef DESCEND_ARGS
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
