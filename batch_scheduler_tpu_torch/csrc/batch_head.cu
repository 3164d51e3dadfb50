// batch_head.cu — the head of one oracle batch, hand-written for Hopper
// (sm_90a): the leftover, the member-capacity matrix, the policy's
// anti-affinity fold, the per-gang feasibility and the Score ranks, in one
// launch on the caller's stream.
//
// Replaces: no Pallas kernel. Its reference is XLA-fused code inside the
// jit'd batch program: batch_scheduler_tpu/ops/oracle.py `schedule_batch`
// (:2091-2102), i.e. `left_resources`, `group_capacity`, policy/terms.py
// `compose_keep_dense`, `gang_feasible` and `score_nodes`. Plain versions:
// the same functions in batch_scheduler_tpu_torch/ops/oracle.py and
// policy/terms.py, chained by ops/batch_kernels.py `batch_head_plain`.
//
// What it computes, for gang rows g < gv and node columns j < nv of the
// output block (node n = n_lo + j):
//   left[n, r]  = alloc[n, r] - requested[n, r]            (all n_total rows)
//   cap[g, j]   = mask[g|0, j] * min over lanes with req[g, r] > 0 of
//                 floor(clamp(left, 0, 2^30) / clamp(req, 1, 2^30))
//                 (2^30 when the row requests nothing), times
//                 keep = !(anti[g] > 0 && any_h node_hash[n, h] == anti[g])
//                 when the anti-affinity term is on
//   score[g, j] = cap > 0 ? 2^30 - cap : -2^30
//   feasible[g] = sum_j min(cap, remaining[g]) >= remaining[g] && valid[g]
// Rows past gv and columns past nv of a [gb, nb] block are written 0 (the
// replicated mesh rung's zero-padded blocks). Which outputs it writes
// follows from the pointers the caller passes: `left_out` alone (a mesh
// follower's leftover), `cap_out` without scores (a rank's capacity
// block), everything (the whole batch), or `cap_in` given (the finish on
// a gathered matrix: scores and feasibility only).
//
// What bounds it on an H100: the [G, N] writes (cap and scores, 64 MiB at
// the north star, 4.3 GB at XL) over the memory rate; the divisions (one
// multiply-shift a gang, requested lane and node) are the next bound, about
// half of the bytes' time at XL, so the design overlaps them with the
// stores.
//
// Layout (`head_plan`, mirrored by ops/batch_kernels.py `head_kernel_plan`):
// a block of 256 threads holds a tile of TG gangs (32 down to 4, the most
// that still gives the card kMinBlocks blocks) by 1,024 nodes, 4
// consecutive nodes a thread. A thread loads its 4 nodes' leftover lanes
// once a tile, every load before any store (the first gang tile's blocks
// then write `left`), and keeps them clamped and doubled (0 where a
// broadcast mask row leaves the node out) in registers up to kRegLanes
// lanes, else in its own slice of shared memory. It then walks the tile's
// gangs, each gang's multiply-shift numbers (ops/assign_scan.py
// `division_magic`, computed here from the request row) in shared memory:
// floor(v / d) = umulhi(2v, m) >> l, three instructions a node and lane
// with no select. The leftover is read once a tile of TG gangs, and
// the 4 nodes' divisions are independent work that hides the stores. Each
// gang row gets one 16-byte streaming store (`st.global.cs.v4`) of cap and
// one of scores a thread, so the output, which nothing in the batch reads
// back, does not evict the leftover and the mask the scan reads next from
// L2. A row whose start is not 16-byte aligned (nb % 4 != 0) shifts its
// quads by the row's offset: each lane takes the next lane's first
// capacities by a warp shuffle and writes the aligned quad that starts in
// its own nodes; lane 0 writes the row's leading nodes and lane 31 its
// trailing ones with scalar streaming stores. A broadcast mask row is read
// once a tile, a per-group row a gang ahead of its use, each as one 32-bit
// word where aligned. The finish keeps four gangs' loads of the gathered
// matrix in flight before their stores.
//
// The grid: the row of node tiles is one thread-block cluster of up to 8
// blocks (block c takes tiles c, c + C, ...), the gang tiles along the
// grid. The feasibility sum accumulates in int64 (it reaches 2^39 at 2^21
// nodes and a 2^18-member gang): each thread's partial in its own shared
// slot across its tiles, a warp and then a block reduction, and across the
// cluster's blocks the first block reads the others' partials from their
// shared memory. The blocks of the first gang tile write `left` of their
// nodes (a mesh block's other nodes by every block, grid-strided); the
// leftover alone is a plain streaming pass of its own.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kBig = 1 << 30;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNodesThread = 4;  // a thread's consecutive nodes: one int4 of an output row
constexpr int kTileNodes = kThreads * kNodesThread;
constexpr int kMaxLanes = 32;
constexpr int kRegLanes = 6;  // leftover lanes a thread keeps in registers; more: shared memory
constexpr int kChunkLanes = 4;  // lanes a thread loads at once into its shared slice
constexpr int kMaxHash = 8;
constexpr int kMaxCluster = 8;
constexpr int kMaxTile = 32;     // gangs a block, at most
constexpr int kMinTile = 4;      // and at least (fewer, fuller blocks beat more at small batches)
constexpr int kMinBlocks = 264;  // blocks a launch wants: two a streaming multiprocessor of an H100
constexpr int kSharedBudget = 216064;  // dynamic shared memory a block: 227 KB less 16 KB static
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kRegs = 0, kShared = 1, kFinish = 2 };

struct Plan {
  int mode, tg, tiles, cluster, gang_tiles, blocks, shared_bytes;
};

// The launch shape for gb gang rows by nb node columns of r lanes, h hash
// lanes, with the feasibility sums (`feas`) or as the finish from a
// gathered matrix (`finish`).
Plan head_plan(int gb, int nb, int r, int h, bool feas, bool finish) {
  Plan p;
  p.mode = finish ? kFinish : (r > kRegLanes ? kShared : kRegs);
  p.tiles = nb > kTileNodes ? (nb + kTileNodes - 1) / kTileNodes : 1;
  p.cluster = p.tiles < kMaxCluster ? p.tiles : kMaxCluster;
  const int fixed = (p.mode == kShared ? r * kTileNodes * 4 : 0) +
                    (p.mode != kFinish ? h * kTileNodes * 4 : 0);
  p.tg = kMaxTile;
  while (p.tg > kMinTile) {
    const long long blocks = (long long)p.cluster * ((gb + p.tg - 1) / p.tg);
    const int acc = feas ? p.tg * kThreads * 8 : 0;
    if (blocks >= kMinBlocks && fixed + acc <= kSharedBudget) break;
    p.tg /= 2;
  }
  p.gang_tiles = (gb + p.tg - 1) / p.tg;
  p.blocks = p.cluster * p.gang_tiles;
  p.shared_bytes = fixed + (feas ? p.tg * kThreads * 8 : 0);
  return p;
}

struct HeadArgs {
  const int* alloc;          // [n_total, r]
  const int* requested;      // [n_total, r]
  const int* req;            // [gv, r]
  const int* remaining;      // [gv]
  const uint8_t* mask;       // row g at mask + g * mask_stride, node j at + j
  const uint8_t* valid;      // [gv]
  const int* anti;           // [gv] or null (the anti-affinity term off)
  const int* node_hash;      // [n_total, h] or null
  const int* cap_in;         // [gv, nb] or null (finish)
  int* left_out;             // [n_total, r] or null
  int* cap_out;              // [gb, nb] or null
  int* scores_out;           // [gb, nb] or null
  uint8_t* feasible_out;     // [gv] or null
  int n_total, r, h, n_lo, nv, gv, gb, nb, mask_stride;
  int tg, tiles, cluster;    // the plan
  int aligned;               // every row of every [gb, nb] matrix starts on a 16-byte boundary
};

// floor(v / d) for v in [0, 2^30] as umulhi(2v, m) >> l, with l = ceil(log2 d)
// and m = 2^(31+l) / d + 1 (ops/assign_scan.py `division_magic`): the same
// value as umulhi(v, m) >> (l - 1), d = 1 (l = 0) included, with no select
__device__ __forceinline__ int div2(unsigned v2, unsigned m, unsigned l) {
  return (int)(__umulhi(v2, m) >> l);
}

__device__ __forceinline__ int score_of(int c) { return c > 0 ? kBig - c : -kBig; }

__device__ __forceinline__ unsigned clamp2(int v) {  // 2 * clamp(v, 0, 2^30)
  return 2u * (unsigned)(v < 0 ? 0 : (v > kBig ? kBig : v));
}

// the mask bytes of nodes js..js+3 of a row (byte i; 0 at or past nv): one
// 32-bit load where the 4 bytes are aligned and inside the row
__device__ __forceinline__ unsigned mask_word(const uint8_t* row, int js, int nv) {
  if (js + 3 < nv && ((uintptr_t)(row + js) & 3) == 0)
    return __ldg(reinterpret_cast<const unsigned*>(row + js));
  unsigned w = 0;
#pragma unroll
  for (int i = 0; i < kNodesThread; ++i)
    if (js + i < nv) w |= (unsigned)__ldg(row + js + i) << (8 * i);
  return w;
}

// bit i: byte i of a mask word is set
__device__ __forceinline__ unsigned word_bits(unsigned w) {
  return ((w & 0xffu) ? 1u : 0u) | ((w & 0xff00u) ? 2u : 0u) | ((w & 0xff0000u) ? 4u : 0u) |
         ((w & 0xff000000u) ? 8u : 0u);
}

// nodes from a row's first 16-byte boundary in a thread's quad: s nodes
// into it, the next lane's first s after its own
__device__ __forceinline__ int4 window(const int (&o)[4], const int (&x)[3], int s) {
  switch (s) {
    case 0: return make_int4(o[0], o[1], o[2], o[3]);
    case 1: return make_int4(o[1], o[2], o[3], x[0]);
    case 2: return make_int4(o[2], o[3], x[0], x[1]);
    default: return make_int4(o[3], x[0], x[1], x[2]);
  }
}

// nodes before the row's first 16-byte boundary
__device__ __forceinline__ int row_shift(const int* row) {
  return (int)((4u - (((uintptr_t)row >> 2) & 3u)) & 3u);
}

// One gang's row of an output (the capacity, or with SCORE its scores):
// this lane's nodes js..js+3 hold o, the next lane's first three x. A
// 16-byte store of the aligned quad that starts s nodes into this lane's
// own; lane 0 writes its first s nodes and lane 31 its last 4 - s alone
// (no lane before or after them in the warp); nothing at or past nb.
template <bool SCORE>
__device__ __forceinline__ void store_row(int* row, int js, int nb, int s, int lane,
                                          const int (&o)[4], const int (&x)[3]) {
  int4 w = window(o, x, s);
  if (SCORE) w = make_int4(score_of(w.x), score_of(w.y), score_of(w.z), score_of(w.w));
  const int e[4] = {w.x, w.y, w.z, w.w};
  if (s != 0 && lane == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      if (i < s && js + i < nb) __stcs(row + js + i, SCORE ? score_of(o[i]) : o[i]);
  }
  if (s != 0 && lane == 31) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (k < 4 - s && js + s + k < nb) __stcs(row + js + s + k, e[k]);
    return;
  }
  const int j = js + s;
  if (j + 3 < nb) {
    __stcs(reinterpret_cast<int4*>(row + j), w);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (j + k < nb) __stcs(row + j + k, e[k]);
  }
}

// the feasibility partial of this thread's 4 nodes: sum of min(cap, rem)
// over the block's nodes (`in` bit i: node js + i is one). `nonneg`: every
// capacity is in [0, 2^30] (the lanes' own), so with rem >= 0 a pair of
// clipped capacities sums in 32 bits.
__device__ __forceinline__ long long partial(const int (&cap)[4], unsigned in, int rem,
                                             bool nonneg) {
  if (nonneg && rem >= 0) {
    unsigned m[4];
#pragma unroll
    for (int i = 0; i < kNodesThread; ++i) m[i] = (in >> i) & 1u ? (unsigned)min(cap[i], rem) : 0u;
    return (long long)(m[0] + m[1]) + (long long)(m[2] + m[3]);
  }
  long long p = 0;
#pragma unroll
  for (int i = 0; i < kNodesThread; ++i)
    if ((in >> i) & 1u) p += (long long)min(cap[i], rem);
  return p;
}

// gang g's capacity and score rows at this thread's 4 nodes
__device__ __forceinline__ void store_gang(const HeadArgs& a, int g, int js, int lane,
                                           const int (&cap)[4]) {
  const size_t o = (size_t)g * a.nb;
  if (a.aligned) {  // whole quads: the shifted path took ~15% longer on the finish (H100)
    if (js < a.nb) {
      if (a.cap_out != nullptr)
        __stcs(reinterpret_cast<int4*>(a.cap_out + o + js),
               make_int4(cap[0], cap[1], cap[2], cap[3]));
      if (a.scores_out != nullptr)
        __stcs(reinterpret_cast<int4*>(a.scores_out + o + js),
               make_int4(score_of(cap[0]), score_of(cap[1]), score_of(cap[2]), score_of(cap[3])));
    }
    return;
  }
  const int sc = a.cap_out != nullptr ? row_shift(a.cap_out + o) : 0;
  const int ss = a.scores_out != nullptr ? row_shift(a.scores_out + o) : 0;
  int nx[3] = {0, 0, 0};
  if (sc != 0 || ss != 0) {  // the same for the whole block: every lane shuffles
#pragma unroll
    for (int k = 0; k < 3; ++k) nx[k] = __shfl_down_sync(kFull, cap[k], 1);
  }
  if (a.cap_out != nullptr) store_row<false>(a.cap_out + o, js, a.nb, sc, lane, cap, nx);
  if (a.scores_out != nullptr) store_row<true>(a.scores_out + o, js, a.nb, ss, lane, cap, nx);
}

// gang row g of the gathered matrix at nodes js..js+3 (0 past nb)
__device__ __forceinline__ int4 load_quad(const HeadArgs& a, int g, int js) {
  const int* row = a.cap_in + (size_t)g * a.nb;
  if (a.aligned || (js + 3 < a.nb && ((uintptr_t)(row + js) & 15) == 0)) {
    if (js < a.nb) return __ldcs(reinterpret_cast<const int4*>(row + js));
    return make_int4(0, 0, 0, 0);
  }
  int q[4];
#pragma unroll
  for (int i = 0; i < kNodesThread; ++i) q[i] = js + i < a.nb ? __ldcs(row + js + i) : 0;
  return make_int4(q[0], q[1], q[2], q[3]);
}

// bit i: node js + i is one of the block's nodes (< nv)
__device__ __forceinline__ unsigned in_bits(int js, int nv) {
  unsigned in = 0;
#pragma unroll
  for (int i = 0; i < kNodesThread; ++i)
    if (js + i < nv) in |= 1u << i;
  return in;
}

// alloc - requested of lanes x0..x0+K-1 of nodes js..js+3 (0 outside the
// block or past r), every load issued before any use
template <int K>
__device__ __forceinline__ void load_raw(const HeadArgs& a, int js, unsigned in, int x0,
                                         int (&raw)[kNodesThread][K]) {
#pragma unroll
  for (int i = 0; i < kNodesThread; ++i) {
    const size_t n = (size_t)a.n_lo + js + i;
#pragma unroll
    for (int x = 0; x < K; ++x)
      raw[i][x] = ((in >> i) & 1u) && x0 + x < a.r
                      ? a.alloc[n * a.r + x0 + x] - a.requested[n * a.r + x0 + x]
                      : 0;
  }
}

// those lanes into `left`
template <int K>
__device__ __forceinline__ void store_left(const HeadArgs& a, int js, unsigned in, int x0,
                                           const int (&raw)[kNodesThread][K]) {
#pragma unroll
  for (int i = 0; i < kNodesThread; ++i) {
    const size_t n = (size_t)a.n_lo + js + i;
#pragma unroll
    for (int x = 0; x < K; ++x)
      if (((in >> i) & 1u) && x0 + x < a.r) a.left_out[n * a.r + x0 + x] = raw[i][x];
  }
}

// MODE kRegs: the leftover lanes in registers, RR of them (the gang table
// marks lanes past r unrequested). kShared: in shared memory, r of at most
// kMaxLanes. kFinish: from cap_in.
template <int MODE, int RR>
__global__ void __launch_bounds__(kThreads, MODE == kShared ? 2 : 3) head_kernel(HeadArgs a) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ __align__(16) uint2 s_div[kMaxTile][RR];  // (magic, shift) of gang b, lane x; ~0: none
  __shared__ int s_anti[kMaxTile];
  __shared__ int s_rem[kMaxTile];
  __shared__ long long s_part[kMaxTile];

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x % a.cluster;  // this block's rank in its cluster
  const int g0 = (blockIdx.x / a.cluster) * a.tg;
  const int rows = min(a.tg, a.gb - g0);
  const bool feas = a.feasible_out != nullptr;
  const bool fold = MODE != kFinish && a.node_hash != nullptr;
  const bool first = g0 == 0 && a.left_out != nullptr;  // this block writes its nodes' left
  const bool per_group = MODE != kFinish && a.mask_stride != 0;
  // dynamic shared memory: the feasibility slots [tg][kThreads], then the
  // leftover lanes, doubled, [r][kTileNodes] (kShared), then the hash lanes
  // [h][kTileNodes]; a thread touches only its own slots and nodes
  long long* s_acc = reinterpret_cast<long long*>(s_dyn);
  long long* my_acc = s_acc + tid;  // this thread's slot of gang b at my_acc[b * kThreads]
  unsigned* s_left = reinterpret_cast<unsigned*>(s_dyn + (feas ? a.tg * kThreads * 8 : 0));
  int* s_hash = reinterpret_cast<int*>(s_left + (MODE == kShared ? a.r * kTileNodes : 0));
  const int own = kNodesThread * tid;  // this thread's first node in a tile

  if (a.left_out != nullptr) {
    // the nodes no tile holds (outside a mesh block's [n_lo, n_lo + nv))
    const long long lo = (long long)a.n_lo * a.r, span = (long long)a.nv * a.r;
    const long long outside = (long long)a.n_total * a.r - span;
    const long long step = (long long)gridDim.x * kThreads;
    for (long long i = (long long)blockIdx.x * kThreads + tid; i < outside; i += step) {
      const long long k = i < lo ? i : i + span;
      a.left_out[k] = a.alloc[k] - a.requested[k];
    }
  }

  if constexpr (MODE != kFinish) {
    for (int i = tid; i < a.tg * RR; i += kThreads) {
      const int b = i / RR, x = i % RR, g = g0 + b;
      const int q = (g < a.gv && x < a.r) ? a.req[(size_t)g * a.r + x] : 0;
      uint2 dv = make_uint2(0u, kFull);
      if (q > 0) {
        const int d = q > kBig ? kBig : q;
        const int l = d > 1 ? 32 - __clz(d - 1) : 0;
        dv = make_uint2((unsigned)((1ull << (31 + l)) / (unsigned long long)d + 1ull),
                        (unsigned)l);
      }
      s_div[b][x] = dv;
    }
  }
  if (tid < a.tg) {
    const int g = g0 + tid;
    s_anti[tid] = (fold && g < a.gv) ? a.anti[g] : 0;
    s_rem[tid] = (feas && g < a.gv) ? a.remaining[g] : 0;
  }
  if (feas)
    for (int b = 0; b < rows; ++b) my_acc[b * kThreads] = 0;
  __syncthreads();

  for (int t = c; t < a.tiles; t += a.cluster) {
    const int js = t * kTileNodes + own;
    const unsigned in = in_bits(js, a.nv);

    if constexpr (MODE == kFinish) {
      // four gangs' loads in flight before any of their stores
      for (int b0 = 0; b0 < rows; b0 += 4) {
        int4 q[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          q[k] = b0 + k < rows ? load_quad(a, g0 + b0 + k, js) : make_int4(0, 0, 0, 0);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int b = b0 + k;
          if (b < rows) {
            const int cap[4] = {q[k].x, q[k].y, q[k].z, q[k].w};
            if (feas) my_acc[b * kThreads] += partial(cap, in, s_rem[b], false);
            store_gang(a, g0 + b, js, lane, cap);
          }
        }
      }
    } else {
      // the nodes a broadcast mask row allows (per-group rows: each gang's)
      const unsigned allow = per_group ? in : (in & word_bits(mask_word(a.mask, js, a.nv)));
      // this tile's leftover: every load before any store, then `left` (the
      // first gang tile's blocks), then the doubled clamp kept for the gangs,
      // 0 at the nodes `allow` leaves out (a gang that asks some lane then
      // gets capacity 0 there from the divisions alone)
      unsigned v2[kNodesThread][MODE == kRegs ? RR : 1];
      if constexpr (MODE == kRegs) {
        int raw[kNodesThread][RR];
        load_raw(a, js, in, 0, raw);
        if (first) store_left(a, js, in, 0, raw);
#pragma unroll
        for (int x = 0; x < RR; ++x)
#pragma unroll
          for (int i = 0; i < kNodesThread; ++i)
            v2[i][x] = (allow >> i) & 1u ? clamp2(raw[i][x]) : 0u;
      } else {
        for (int x0 = 0; x0 < a.r; x0 += kChunkLanes) {
          int chunk[kNodesThread][kChunkLanes];
          load_raw(a, js, in, x0, chunk);
          if (first) store_left(a, js, in, x0, chunk);
#pragma unroll
          for (int x = 0; x < kChunkLanes; ++x) {
            if (x0 + x >= a.r) break;
            unsigned w[kNodesThread];
#pragma unroll
            for (int i = 0; i < kNodesThread; ++i)
              w[i] = (allow >> i) & 1u ? clamp2(chunk[i][x]) : 0u;
            *reinterpret_cast<uint4*>(s_left + (x0 + x) * kTileNodes + own) =
                make_uint4(w[0], w[1], w[2], w[3]);
          }
        }
      }
      if (fold)
        for (int x = 0; x < a.h; ++x) {
          int hv[kNodesThread];
#pragma unroll
          for (int i = 0; i < kNodesThread; ++i)
            hv[i] = (in >> i) & 1u ? a.node_hash[((size_t)a.n_lo + js + i) * a.h + x] : 0;
          *reinterpret_cast<int4*>(s_hash + x * kTileNodes + own) =
              make_int4(hv[0], hv[1], hv[2], hv[3]);
        }
      // a per-group mask row's word, loaded a gang ahead
      unsigned next = per_group && rows > 0 && g0 < a.gv
                          ? mask_word(a.mask + (size_t)g0 * a.mask_stride, js, a.nv) : 0u;

      for (int b = 0; b < rows; ++b) {
        const int g = g0 + b;
        unsigned word = 0;
        if (per_group) {
          word = next;
          if (b + 1 < rows && g + 1 < a.gv)
            next = mask_word(a.mask + (size_t)(g + 1) * a.mask_stride, js, a.nv);
        }
        // the lanes' capacity bound; `asks`: the gang asks some lane
        int cap[kNodesThread] = {kBig, kBig, kBig, kBig};
        bool asks = false;
        if constexpr (MODE == kRegs) {
#pragma unroll
          for (int x = 0; x < RR; ++x) {
            const uint2 dv = s_div[b][x];
            if (dv.y != kFull) {
              asks = true;
#pragma unroll
              for (int i = 0; i < kNodesThread; ++i)
                cap[i] = min(cap[i], div2(v2[i][x], dv.x, dv.y));
            }
          }
        } else {
          for (int x = 0; x < a.r; ++x) {
            const uint2 dv = s_div[b][x];
            if (dv.y != kFull) {
              asks = true;
              const uint4 w = *reinterpret_cast<const uint4*>(s_left + x * kTileNodes + own);
              cap[0] = min(cap[0], div2(w.x, dv.x, dv.y));
              cap[1] = min(cap[1], div2(w.y, dv.x, dv.y));
              cap[2] = min(cap[2], div2(w.z, dv.x, dv.y));
              cap[3] = min(cap[3], div2(w.w, dv.x, dv.y));
            }
          }
        }
        // the zeros the divisions do not give: a gang that asks nothing (2^30
        // where allowed), a per-group mask row, the anti-affinity fold, and
        // rows past gv
        const int anti = s_anti[b];
        if (g >= a.gv) {
#pragma unroll
          for (int i = 0; i < kNodesThread; ++i) cap[i] = 0;
        } else if (!asks || per_group || (fold && anti > 0)) {
          unsigned ok = allow;
          if (per_group) ok &= word_bits(word);
          if (fold && anti > 0) {
            for (int x = 0; x < a.h; ++x) {
              const int4 w = *reinterpret_cast<const int4*>(s_hash + x * kTileNodes + own);
              ok &= ~((w.x == anti ? 1u : 0u) | (w.y == anti ? 2u : 0u) |
                      (w.z == anti ? 4u : 0u) | (w.w == anti ? 8u : 0u));
            }
          }
#pragma unroll
          for (int i = 0; i < kNodesThread; ++i)
            if (!((ok >> i) & 1u)) cap[i] = 0;
        }
        if (feas) my_acc[b * kThreads] += partial(cap, in, s_rem[b], true);
        store_gang(a, g, js, lane, cap);
      }
    }
  }

  if (!feas) return;  // no exchange: every block of the cluster returns here
  __syncthreads();
  for (int b = warp; b < rows; b += kWarps) {
    long long v = 0;
    for (int k = lane; k < kThreads; k += 32) v += s_acc[b * kThreads + k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    if (lane == 0) s_part[b] = v;
  }
  cluster.sync();  // every block's partials are in its shared memory
  if (c == 0) {
    for (int b = tid; b < rows; b += kThreads) {
      const int g = g0 + b;
      if (g < a.gv) {
        long long total = 0;
        for (int k = 0; k < a.cluster; ++k) total += *cluster.map_shared_rank(&s_part[b], k);
        a.feasible_out[g] = (uint8_t)(total >= (long long)s_rem[b] && a.valid[g] != 0);
      }
    }
  }
  cluster.sync();  // no block leaves while the first still reads its partials
}

// the leftover alone: a streaming pass, 16 bytes a thread where all three
// arrays are aligned
__global__ void __launch_bounds__(kThreads) left_kernel(const int* alloc, const int* requested,
                                                        int* left, long long total, int vec) {
  const long long step = (long long)gridDim.x * kThreads;
  const long long i0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long quads = total / 4;
    for (long long i = i0; i < quads; i += step) {
      const int4 p = reinterpret_cast<const int4*>(alloc)[i];
      const int4 q = reinterpret_cast<const int4*>(requested)[i];
      reinterpret_cast<int4*>(left)[i] = make_int4(p.x - q.x, p.y - q.y, p.z - q.z, p.w - q.w);
    }
    done = quads * 4;
  }
  for (long long i = done + i0; i < total; i += step) left[i] = alloc[i] - requested[i];
}

cudaError_t launch_left(const int* alloc, const int* requested, int* left, int n_total, int r,
                        cudaStream_t stream) {
  const long long total = (long long)n_total * r;
  if (total < 1) return cudaSuccess;
  const bool vec = (((uintptr_t)alloc | (uintptr_t)requested | (uintptr_t)left) & 15) == 0;
  const long long want = ((vec ? total / 4 : total) + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 1 ? 1 : (want < 1024 ? want : 1024));
  left_kernel<<<blocks, kThreads, 0, stream>>>(alloc, requested, left, total, vec ? 1 : 0);
  return cudaGetLastError();
}

// The instantiation's dynamic shared memory limit raised to the budget,
// once a device: the attribute is the function's, and setting it costs
// host time a call
template <int MODE, int RR>
cudaError_t allow_shared() {
  static std::atomic<unsigned> done{0};  // bit d: raised on device d
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit != 0 && (done.load(std::memory_order_acquire) & bit) != 0) return cudaSuccess;
  e = cudaFuncSetAttribute((const void*)head_kernel<MODE, RR>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedBudget);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

template <int MODE, int RR>
cudaError_t launch(const HeadArgs& a, const Plan& p, cudaStream_t stream) {
  cudaError_t e = allow_shared<MODE, RR>();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.shared_bytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  // the row's blocks are one cluster only where they exchange feasibility
  // partials: a cluster launch costs a few microseconds more
  cfg.numAttrs = a.feasible_out != nullptr && p.cluster > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, head_kernel<MODE, RR>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* bst_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The plan of a launch with these sizes (see head_plan), for the tests:
// out[0..6] = mode (0 registers, 1 shared memory, 2 finish), TG, node
// tiles, cluster blocks, gang tiles, blocks, dynamic shared bytes.
void bst_batch_head_plan(int gb, int nb, int r, int h, int feasible, int finish, int* out) {
  const Plan p = head_plan(gb, nb, r, h, feasible != 0, finish != 0);
  const int v[7] = {p.mode, p.tg, p.tiles, p.cluster, p.gang_tiles, p.blocks, p.shared_bytes};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}

// One launch of the head. Pointers the mode does not use are null (see
// the header). Returns a CUDA error code.
int bst_batch_head(const int* alloc, const int* requested, const int* req, const int* remaining,
                   const uint8_t* mask, const uint8_t* valid, const int* anti,
                   const int* node_hash, const int* cap_in, int* left_out, int* cap_out,
                   int* scores_out, uint8_t* feasible_out, int n_total, int r, int h, int n_lo,
                   int nv, int gv, int gb, int nb, int mask_stride, void* stream) {
  const bool rows = cap_in != nullptr || cap_out != nullptr || scores_out != nullptr ||
                    feasible_out != nullptr;
  if (r < 1 || r > kMaxLanes || n_total < 0 || h < 0 || h > kMaxHash || gv < 0 || gb < gv ||
      nb < nv || nv < 0 || n_lo < 0)
    return (int)cudaErrorInvalidValue;
  // a finish reads the gathered matrix, not the lanes
  if (rows && cap_in == nullptr && (n_lo + nv > n_total || mask == nullptr))
    return (int)cudaErrorInvalidValue;
  if (cap_in != nullptr && (gv != gb || nv != nb)) return (int)cudaErrorInvalidValue;
  if (feasible_out != nullptr && (remaining == nullptr || valid == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((node_hash != nullptr) != (anti != nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (!rows || gb == 0) {
    // the leftover alone (or no gang row to hold it)
    if (left_out == nullptr) return (int)cudaSuccess;
    return (int)launch_left(alloc, requested, left_out, n_total, r, s);
  }
  const Plan p = head_plan(gb, nb, r, node_hash != nullptr ? h : 0, feasible_out != nullptr,
                           cap_in != nullptr);
  const HeadArgs a = {alloc, requested, req, remaining, mask, valid, anti, node_hash, cap_in,
                      left_out, cap_out, scores_out, feasible_out, n_total, r,
                      node_hash != nullptr ? h : 0, n_lo, nv, gv, gb, nb, mask_stride,
                      p.tg, p.tiles, p.cluster,
                      nb % 4 == 0 && (((uintptr_t)cap_in | (uintptr_t)cap_out |
                                       (uintptr_t)scores_out) & 15) == 0};
  if (p.mode == kFinish) return (int)launch<kFinish, 1>(a, p, s);
  if (p.mode == kShared) return (int)launch<kShared, kMaxLanes>(a, p, s);
  return (int)launch<kRegs, kRegLanes>(a, p, s);
}

}  // extern "C"
