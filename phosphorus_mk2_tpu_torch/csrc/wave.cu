// Wave-loop kernels of the cluster tracer for Hopper (sm_90a).
//
// row_gather replaces the Pallas TPU kernel of tools/tpu_r4q_dma.py:46
// (called at :103): R row copies out of a (K, 9, 128) float32 table by an
// index vector, inside one kernel, in two variants. That kernel was a
// probe: it asked what it costs a kernel to fetch each ray's own cluster
// row itself, which decides whether the body of a wave can be one kernel
// that never writes the gathered rows out. Here the answer is put to
// work: wave_mt and wave_sweep are that fused body, and the row fetch
// they run (fetch_row below) is the routine row_gather times.
//
//   row_gather  out[i] = table[idx[i]], bit for bit. "direct": one warp
//               per row, 36 coalesced 128-byte loads into registers, 36
//               stores. "staged": a warp walks several rows through a
//               ring of NBUF shared-memory slots; one lane starts each
//               row's copy as a single bulk asynchronous copy
//               (cp.async.bulk) that reports to an mbarrier, NBUF copies
//               ahead, and the warp reads the slot with the same
//               fetch_row once the barrier's phase has flipped. These are
//               the probe's "serial" (fetch, then use) and "pipe" (NBUF
//               copies in flight) in this card's terms. The probe kept a
//               checksum; here the rows are written out so that the
//               result can be compared with plain indexing.
//   wave_mt     the body of one wave of the tracer (the JAX package's
//               cluster_traverse.py chunk_fn: live gate, row gather,
//               _mt_rows, masked state update), which has no Pallas kernel
//               behind it. A warp takes G consecutive rays (G = 8, 16 or
//               32, from the host's plan), a lane a ray for the gate: the
//               lane reads its ray's best t ONCE and, for each of the W
//               table columns, the tnear and the cluster id; a column is
//               live when tnear < best_t, tnear < T_MAX, the id lies in
//               [0, K) and, for an any-hit trace, the ray has no hit yet.
//               A block whose rays are all dead leaves after those loads,
//               so a sparse wave costs one pass over ~12 bytes a ray and
//               column. Per column, __match_any_sync groups a warp's live
//               lanes by cluster id, and each group becomes an item of the
//               block's list in shared memory (the lanes' origin,
//               direction and best t beside it). The block's warps then
//               take items from that list until it is empty: the warp that
//               takes one fetches the group's row ONCE (lane l holds
//               triangles l, l + 32, l + 64, l + 96) and walks the group's
//               rays, each ray's inputs a broadcast read; the lanes test
//               their four triangles with the Moller-Trumbore arithmetic
//               of csrc/mt.cu in the same order of operations, accepting a
//               hit only on t < best t, and the ray's winner for that
//               column is the minimum t and, among equal t, the lowest
//               flat index w * 128 + triangle: two integer warp reductions
//               (t >= 0, so its float bits order as integers). The least
//               (t, flat) over the ray's columns is kept in its slot and
//               written once at the end. That is the minimum over every
//               live (column, triangle) pair of the ray, which depends
//               neither on how the rays were grouped nor on which warp
//               took which group in what order: the result is the
//               one-warp-per-ray walk's to the bit.
//   wave_sweep  the exact fallback (the JAX package's cluster_traverse.py
//               fallback, XLA, no Pallas kernel): for each of m listed
//               rays, every cluster of the table. The plain version walks
//               the clusters in ascending blocks and carries a strict
//               t < best_t from block to block, so its winner is the
//               candidate with the least (t, cluster * 128 + triangle) in
//               lexicographic order among those with t below the ray's
//               starting best t: a later candidate replaces an earlier one
//               only if strictly nearer, and re-testing a block (the last
//               one overlaps the one before) changes nothing. That
//               minimum does not depend on the order of evaluation, so
//               the work is cut as (ray tiles) x (cluster ranges), from
//               the host's plan, each range of a tile one block, and a
//               fetched row serves the whole tile. Two layouts, picked by
//               the tile: 4 rays a warp (lane l holds
//               triangles l, l + 32, l + 64, l + 96 of the row it
//               fetched, as in wave_mt, and keeps a LaneBest per ray in
//               registers over its range; each ray is reduced over the
//               warp once, at the end); tiles of 32 rays with the rows
//               staged in shared memory for the block, a thread a ray
//               and a slice of the row (mt_closest's layout, as
//               csrc/mt.cu has it), skipping the row's empty quads. The blocks meet in one atomicMin of a
//               64-bit key (t bits << 32 | flat index) a ray with a hit,
//               and the last block of a tile writes the state: one launch
//               a call.
//
// What bounds them on an H100: bytes. A (ray, cluster) pair reads a
// 4,608-byte row and does 128 tests of ~46 operations: 1.3 operations a
// byte, far below the card's ~20 FP32 operations a byte. The rows of one
// wave are scattered over the table, but each is 36 full 128-byte lines,
// so the fetch is as coalesced as a row-major copy; a table of tens of
// megabytes (26.7 MB for 5,803 clusters) stays in the 50 MB L2 after its
// first touch. For wave_mt the least is each DISTINCT cluster's row once
// (the table is one input) plus ~12 bytes of gate a ray and column; what
// it reads is each group's row once, where a group is the rays of one
// warp that want one cluster in one column: in a dense wave of rays in
// pixel order neighbouring rays share clusters (terrain camera rays, wave
// 1: ~6.6 rays a group at G = 16), and a warp of G rays reads a shared row
// once instead of once a ray. What its design does about the rest: a lane
// per ray for the gate, so a sparse wave meets n / G warps instead of n;
// the groups of a block shared out among its warps, so rays that are live
// together (neighbours, in pixel order) are not tested one after the
// other by one warp; and G chosen from n and the card's resident warps.
// What holds a dense wave in practice is instruction issue, not bytes: a
// pair is 338 instructions as compiled (cuobjdump), an issue floor of
// 0.012 ms for terrain wave 1 of 65,536 rays on an H100 at 1,980 MHz,
// which no grouping removes; the measured time is 2-3x that floor.
// For wave_sweep the least is the table once (0.008 ms for 26.7 MB) plus
// the tests of the real triangles (a row's lanes past its cluster's
// triangles are zero pads: the terrain's 5,803 rows hold 530,912
// triangles in 742,784 lanes), whose issue is ~300 instructions a 128
// tests as compiled: ~0.01 ms at 8 rays x 5,803 clusters, ~2.4 ms at
// 2,048 rays. A block a ray would fetch each row once a RAY and read the
// table m times; here a tile reads it once, ceil(m / tile) times in all.
// What is left is issue, and the two layouts differ there: the warp
// layout's rows come from L2 into registers at the top of each step, and
// it ran ~1.6x its issue floor over every lane at 2,048 rays; with the
// rows staged for a block the threads test from shared memory, and skip
// the quads of pads, a warp at a time. A few rays cannot fill a block of
// threads (the staged layout takes ~0.07 ms for 1 to 32 rays, the warp
// layout 0.012 for 1 and 0.064 for 16), so up to 16 go to the warp
// layout; the plan gives enough blocks for the card's resident warps
// whatever m is.
//
// Exactness: compiled with --fmad=false and IEEE division, no fast
// math, so t equals the plain PyTorch version's bit for bit. A winning t
// of -0.0 is stored as +0.0 (the integer order of the reduction needs
// it; as floats the two are equal), and the plain mt_rows does the same.
//
// Row types. wave_mt and both wave_sweep kernels are templates on the
// element type of the row table: float, or __nv_bfloat16 (the tracer's
// rows_bf16: 2,304 bytes a row instead of 4,608). A bf16 value is widened
// to float exactly as it is loaded (__bfloat162float), and everything
// after the load is the float kernel's: the same Moller-Trumbore, tie
// rule and reductions. The JAX package promotes bf16 x float32 to
// float32, so its arithmetic too is float32 on the quantized values, and
// the plain versions upcast the gathered rows before mt_rows. The staged
// sweep skips a quad whose four first edges are zero as loaded (bf16
// zero widens to float zero, so the test is the same either side of the
// widening). The loads of a bf16 row are simple: a lane reads single
// halves in wave_mt and the warp sweep (64 bytes a warp a load), and the
// staged sweep reads a thread's four triangles of a component as one
// 8-byte load; a faster bf16 fetch is later work.
//
// Ray order. wave_mt takes an optional list `order` of m distinct rays:
// lane `at` then gates ray order[at] instead of ray `at` (its origin,
// direction, columns and state all read through that index, and its
// winner written back there). The tracer's wave_dedup passes the rays
// sorted by the cluster of their column, so that the rays of a warp want
// few clusters and __match_any_sync's groups fetch each row once for many
// rays. A ray's winner is the least (t, flat) over its own live pairs
// whichever warp meets it, so the state is the unordered launch's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int C = 128;                 // triangles of a cluster row
constexpr int COMPS = 9;               // a xyz, e0 xyz, e1 xyz
constexpr int ROW = COMPS * C;         // floats of a row
constexpr int ROW_BYTES = ROW * 4;     // 4,608
constexpr int PER_LANE = C / 32;       // triangles a lane owns
constexpr float T_MAX = 3.4e38f;
constexpr float DET_EPS = 1e-8f;
constexpr unsigned FULL = 0xFFFFFFFFu;

constexpr int GATHER_WARPS = 8;        // row_gather direct: rows per block
constexpr int STAGED_WARPS = 4;        // row_gather staged: warps per block
constexpr int NBUF = 4;                // ring slots (copies in flight) per warp
constexpr int STAGED_ROWS = 8;         // rows a warp walks through its ring
constexpr int MT_WARPS = 8;            // wave_mt: warps per block (G rays each)
constexpr int SWEEP_WARPS = 8;         // wave_sweep, a warp a tile: warps per block
constexpr int WARP_TILE = 4;           //   and rays a tile
constexpr int SWEEP_THREADS = 128;     // wave_sweep, rows staged: threads per block
constexpr int STAGED_TILE = 32;        //   and rays a tile

// A row element as a float: the identity, or the exact widening of a bf16.
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// Four consecutive elements (16-byte aligned for float, 8 for bf16) of a
// row staged in shared memory, as floats: one LDS.128 or one LDS.64.
__device__ __forceinline__ float4 load4(const float* q) {
  return *reinterpret_cast<const float4*>(q);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* q) {
  const uint2 u = *reinterpret_cast<const uint2*>(q);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// The row fetch: lane l takes, of each of the 9 component rows, columns
// l, l + 32, l + 64 and l + 96, so every load of the warp is one
// 128-byte line (64 bytes for bf16). `row` points at a row in device
// memory or at a staged copy of one in shared memory.
template <typename T>
__device__ __forceinline__ void fetch_row(const T* row, int lane,
                                          float (&v)[COMPS][PER_LANE]) {
#pragma unroll
  for (int r = 0; r < COMPS; ++r) {
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) v[r][i] = widen(row[r * C + i * 32 + lane]);
  }
}

__device__ __forceinline__ void store_row(float* row, int lane,
                                          const float (&v)[COMPS][PER_LANE]) {
#pragma unroll
  for (int r = 0; r < COMPS; ++r) {
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) row[r * C + i * 32 + lane] = v[r][i];
  }
}

// Moller-Trumbore of one ray against one triangle; the arithmetic of
// csrc/mt.cu mt_test and of the plain mt_rows, in their order. Returns
// the validity of the hit; t is always written.
__device__ __forceinline__ bool mt_hit(float ax, float ay, float az, float e0x, float e0y,
                                       float e0z, float e1x, float e1y, float e1z,
                                       float px, float py, float pz,
                                       float dx, float dy, float dz, float& t) {
  const float pvx = dy * e1z - dz * e1y;
  const float pvy = dz * e1x - dx * e1z;
  const float pvz = dx * e1y - dy * e1x;
  const float det = e0x * pvx + e0y * pvy + e0z * pvz;
  const bool near0 = fabsf(det) < DET_EPS;
  const float ood = 1.0f / (near0 ? 1.0f : det);
  const float tx = px - ax;
  const float ty = py - ay;
  const float tz = pz - az;
  const float u = (tx * pvx + ty * pvy + tz * pvz) * ood;
  const float qvx = ty * e0z - tz * e0y;
  const float qvy = tz * e0x - tx * e0z;
  const float qvz = tx * e0y - ty * e0x;
  const float vv = (dx * qvx + dy * qvy + dz * qvz) * ood;
  t = (e1x * qvx + e1y * qvy + e1z * qvz) * ood;
  return !near0 && u >= 0.0f && u <= 1.0f && vv >= 0.0f && u + vv <= 1.0f &&
         t >= 0.0f;
}

// The same against triangle i of a lane's fetched row.
__device__ __forceinline__ bool mt_test(const float (&v)[COMPS][PER_LANE], int i,
                                        float px, float py, float pz,
                                        float dx, float dy, float dz, float& t) {
  return mt_hit(v[0][i], v[1][i], v[2][i], v[3][i], v[4][i], v[5][i], v[6][i], v[7][i],
                v[8][i], px, py, pz, dx, dy, dz, t);
}

// A lane's running winner over the triangles it meets in ascending flat
// index: a hit is taken only when strictly nearer than the ray's best t
// at entry and than the lane's own, so the lane keeps its first minimum.
struct LaneBest {
  float t = T_MAX;
  int flat = INT_MAX;
};

__device__ __forceinline__ void test_row(const float (&v)[COMPS][PER_LANE], int lane,
                                         int flat_base, float px, float py, float pz,
                                         float dx, float dy, float dz, float bt,
                                         LaneBest& best) {
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    float t;
    if (mt_test(v, i, px, py, pz, dx, dy, dz, t) && t < bt && t < best.t) {
      best.t = (t == 0.0f) ? 0.0f : t;  // -0.0 -> +0.0
      best.flat = flat_base + i * 32 + lane;
    }
  }
}

// The warp's winner: the minimum t and, among equal t, the lowest flat
// index. t is non-negative, so its bits order as integers. Returns the
// bits of T_MAX when no lane holds a hit.
__device__ __forceinline__ int warp_winner(const LaneBest& best, int& flat) {
  const int tb = __float_as_int(best.t);
  const int mb = __reduce_min_sync(FULL, tb);
  flat = __reduce_min_sync(FULL, tb == mb ? best.flat : INT_MAX);
  return mb;
}

// ---------------------------------------------------------------------------
// row_gather
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(GATHER_WARPS * 32)
row_gather_direct_kernel(const int* __restrict__ idx, const float* __restrict__ table,
                         int r, float* __restrict__ out) {
  const int row = blockIdx.x * GATHER_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= r) return;
  float v[COMPS][PER_LANE];
  fetch_row(table + static_cast<size_t>(idx[row]) * ROW, lane, v);
  store_row(out + static_cast<size_t>(row) * ROW, lane, v);
}

__device__ __forceinline__ uint32_t shared_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// Start the copy of one row into a ring slot: the barrier is told how
// many bytes to expect, then one bulk copy is started that reports to it.
__device__ __forceinline__ void stage_row(float* slot, const float* src, uint64_t* bar) {
  const uint32_t bar_a = shared_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar_a), "r"(ROW_BYTES) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(shared_addr(slot)), "l"(src), "r"(ROW_BYTES), "r"(bar_a) : "memory");
}

__device__ __forceinline__ void wait_row(uint64_t* bar, uint32_t parity) {
  const uint32_t bar_a = shared_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar_a), "r"(parity) : "memory");
  } while (!done);
}

// Dynamic shared memory: per warp NBUF row slots, then per warp NBUF
// barriers. A warp owns rows [first, first + count) and never meets the
// block's other warps.
__global__ void __launch_bounds__(STAGED_WARPS * 32)
row_gather_staged_kernel(const int* __restrict__ idx, const float* __restrict__ table,
                         int r, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* ring = reinterpret_cast<float*>(smem) + warp * NBUF * ROW;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + STAGED_WARPS * NBUF * ROW_BYTES) + warp * NBUF;
  const int first = (blockIdx.x * STAGED_WARPS + warp) * STAGED_ROWS;
  const int count = min(STAGED_ROWS, r - first);
  if (count <= 0) return;
  if (lane == 0) {
    for (int s = 0; s < NBUF; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   :: "r"(shared_addr(bars + s)), "r"(1) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < min(NBUF, count); ++i) {
      stage_row(ring + i * ROW, table + static_cast<size_t>(idx[first + i]) * ROW, bars + i);
    }
  }
  __syncwarp();
  for (int i = 0; i < count; ++i) {
    const int s = i % NBUF;
    wait_row(bars + s, (i / NBUF) & 1);
    float v[COMPS][PER_LANE];
    fetch_row(ring + s * ROW, lane, v);
    store_row(out + static_cast<size_t>(first + i) * ROW, lane, v);
    __syncwarp();  // every lane has read the slot: it may be filled again
    if (lane == 0 && i + NBUF < count) {
      stage_row(ring + s * ROW, table + static_cast<size_t>(idx[first + i + NBUF]) * ROW,
                bars + s);
    }
  }
}

// ---------------------------------------------------------------------------
// wave_mt
// ---------------------------------------------------------------------------

// Warp v takes rays [v * g, v * g + g); lane l < g gates ray v * g + l,
// whose slot in the block is threadIdx.x. Per column, each warp's groups
// go into the block's list of items; every warp of the block then takes
// items from the list until it is empty (the processing is shared by the
// block, so a warp whose rays are all live does not work alone). Every
// branch on a ballot, a match, an item or a group is uniform over the
// warp, and every thread reaches every __syncthreads.
// The rays of one group against its row v (column j): each ray's winner
// merged into its slot. Only the calling warp holds these rays in this
// column.
__device__ __forceinline__ void test_group(const float (&v)[COMPS][PER_LANE], int lane, int j,
                                           int gc, int base, unsigned rays,
                                           const float (*s_ray)[7], int (*s_win)[MT_WARPS * 32]) {
  for (; rays != 0u; rays &= rays - 1u) {
    const int q = base + __ffs(rays) - 1;
    const float* r = s_ray[q];
    LaneBest best;
    test_row(v, lane, j * C, r[0], r[1], r[2], r[3], r[4], r[5], r[6], best);
    int flat;
    const int mb = warp_winner(best, flat);
    if (lane == 0 && (mb < s_win[0][q] || (mb == s_win[0][q] && flat < s_win[1][q]))) {
      s_win[0][q] = mb;  // the ray's least (t, flat) over its columns
      s_win[1][q] = flat;
      s_win[2][q] = gc;
    }
  }
}

// Lanes run over n entries: rays 0..n-1, or with `order` the n rays
// order[0..n-1].
template <typename T>
__global__ void __launch_bounds__(MT_WARPS * 32)
wave_mt_kernel(const float* __restrict__ p, const float* __restrict__ d,
               const T* __restrict__ table, int k,
               const float* __restrict__ col_t, const int* __restrict__ col_c,
               long long stride_t, long long stride_c, int w, int any_hit, int n, int g,
               const int* __restrict__ order, float* best_t, int* best_c, int* best_l) {
  __shared__ float s_ray[MT_WARPS * 32][7];     // origin, direction, best t at the call
  __shared__ int s_win[3][MT_WARPS * 32];       // the ray's least (t bits, flat), cluster
  __shared__ int s_cid[MT_WARPS * 32];          // items: a group's cluster,
  __shared__ unsigned s_rays[MT_WARPS * 32];    // its lanes
  __shared__ int s_owner[MT_WARPS * 32];        // and their warp
  __shared__ int s_items, s_next;

  const int slot = threadIdx.x;
  const int warp = slot >> 5;
  const int lane = slot & 31;
  const long long at = static_cast<long long>(blockIdx.x * MT_WARPS + warp) * g + lane;
  const bool mine = lane < g && at < n;
  const int ray = mine ? (order != nullptr ? order[at] : static_cast<int>(at)) : 0;
  float bt = 0.f;  // the ray's best t, read once: every column meets this value
  bool open = false;
  if (mine) {
    bt = best_t[ray];
    open = !(any_hit && best_c[ray] >= 0);
  }
  const float* ct = col_t + static_cast<size_t>(ray) * stride_t;  // read only when open
  const int* cc = col_c + static_cast<size_t>(ray) * stride_c;
  s_win[0][slot] = __float_as_int(T_MAX);
  s_win[1][slot] = INT_MAX;  // no hit yet
  s_win[2][slot] = -1;
  if (slot == 0) s_items = s_next = 0;
  bool loaded = false;
  __syncthreads();
  for (int j = 0; j < w; ++j) {
    // the id of a dead column is arbitrary; one of a live column lies in
    // [0, k), and nothing else is ever used as an address
    int cid = -1;
    if (open) {
      const float tn = ct[j];
      const int c = cc[j];  // read beside tnear: one round trip, not two
      if (tn < bt && tn < T_MAX && c >= 0 && c < k) cid = c;
    }
    if (cid >= 0 && !loaded) {
      s_ray[slot][0] = p[3 * ray], s_ray[slot][1] = p[3 * ray + 1];
      s_ray[slot][2] = p[3 * ray + 2], s_ray[slot][3] = d[3 * ray];
      s_ray[slot][4] = d[3 * ray + 1], s_ray[slot][5] = d[3 * ray + 2];
      s_ray[slot][6] = bt;
      loaded = true;
    }
    const unsigned same = __match_any_sync(FULL, cid);  // the lanes that want my cluster
    if (cid >= 0 && __ffs(same) - 1 == lane) {          // a group's first lane lists it
      const int it = atomicAdd(&s_items, 1);
      s_cid[it] = cid;
      s_rays[it] = same;
      s_owner[it] = warp;
    }
    __syncthreads();
    const int items = s_items;
    for (;;) {
      int it = 0;
      if (lane == 0) it = atomicAdd(&s_next, 1);
      it = __shfl_sync(FULL, it, 0);
      if (it >= items) break;
      float v[COMPS][PER_LANE];
      fetch_row(table + static_cast<size_t>(s_cid[it]) * ROW, lane, v);  // once a group
      test_group(v, lane, j, s_cid[it], s_owner[it] * 32, s_rays[it], s_ray, s_win);
    }
    __syncthreads();  // every item of this column is done
    if (slot == 0) s_items = s_next = 0;
    __syncthreads();
  }
  // every accepted hit has t < bt; no hit leaves flat at INT_MAX
  if (mine && s_win[1][slot] != INT_MAX) {
    best_t[ray] = __int_as_float(s_win[0][slot]);
    best_c[ray] = s_win[2][slot];
    best_l[ray] = s_win[1][slot] % C;
  }
}

// ---------------------------------------------------------------------------
// wave_sweep
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned long long sweep_key(float t, int flat) {
  return (static_cast<unsigned long long>(__float_as_uint(t)) << 32) | static_cast<unsigned>(flat);
}

// The end of every block of both sweep kernels, once its keys are in
// keys[j0, j0 + nr) (atomicMin): the last block of the tile to finish,
// found by the tile's counter, writes each ray's key over its state and
// puts the key back to "none". atomicInc wraps the counter back to 0, so
// the counters and the keys are as the next call needs them. Every key
// that was written beats the ray's state (its t was below the best t at
// the call).
__device__ __forceinline__ void finish_tile(int tile, int j0, int nr, int splits,
                                            const int* __restrict__ idx,
                                            unsigned long long* keys, unsigned* done,
                                            float* best_t, int* best_c, int* best_l) {
  __shared__ int s_last;
  __threadfence();  // this block's keys are visible before the count says so
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicInc(done + tile, static_cast<unsigned>(splits - 1)) ==
             static_cast<unsigned>(splits - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int j = threadIdx.x; j < nr; j += blockDim.x) {
    const unsigned long long key = __ldcg(keys + j0 + j);
    if (key != ~0ull) {
      const int ray = idx[j0 + j];
      const int flat = static_cast<int>(key & 0xFFFFFFFFull);
      best_t[ray] = __int_as_float(static_cast<int>(key >> 32));
      best_c[ray] = flat / C;
      best_l[ray] = flat % C;
      keys[j0 + j] = ~0ull;
    }
  }
}

// A warp a tile of R = WARP_TILE rays (few rays). Block b takes ray tile
// b / splits (listed rays [tile * R, tile * R + nr)) and cluster range
// [c0, c1) of split b % splits; its warps take the range's clusters in
// turn. A warp
// fetches each row ONCE and tests it for every ray of the tile, keeping a
// LaneBest per ray in registers over its whole range, and reduces each
// ray over the warp once, at the end; the block's warps meet in shared
// memory, and the block issues one atomicMin a ray that found a hit.
// Every branch on nr or r is uniform over the block.
template <typename T>
__global__ void __launch_bounds__(SWEEP_WARPS * 32)
wave_sweep_warp_kernel(const float* __restrict__ p, const float* __restrict__ d,
                       const T* __restrict__ table, int k, const int* __restrict__ idx,
                       int m, int splits, int per_block, float* best_t, int* best_c,
                       int* best_l, unsigned long long* keys, unsigned* done) {
  constexpr int R = WARP_TILE;
  __shared__ float s_ray[R][7];  // origin, direction, best t at the call
  __shared__ unsigned long long s_key[R];
  const int tile = blockIdx.x / splits;
  const int j0 = tile * R;
  const int nr = min(R, m - j0);
  const int c0 = (blockIdx.x - tile * splits) * per_block;
  const int c1 = min(k, c0 + per_block);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < nr) {
    const int ray = idx[j0 + threadIdx.x];
    float* r = s_ray[threadIdx.x];
    r[0] = p[3 * ray], r[1] = p[3 * ray + 1], r[2] = p[3 * ray + 2];
    r[3] = d[3 * ray], r[4] = d[3 * ray + 1], r[5] = d[3 * ray + 2];
    r[6] = best_t[ray];
    s_key[threadIdx.x] = ~0ull;
  }
  __syncthreads();
  LaneBest best[R];
  for (int c = c0 + warp; c < c1; c += SWEEP_WARPS) {
    float v[COMPS][PER_LANE];
    fetch_row(table + static_cast<size_t>(c) * ROW, lane, v);  // once for the tile
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nr) {
        // read anew for each row: kept in registers, the tile's rays
        // would cost 7 R of them and resident warps with them
        const volatile float* q = s_ray[r];
        test_row(v, lane, c * C, q[0], q[1], q[2], q[3], q[4], q[5], q[6], best[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < nr) {
      int flat;
      const int mb = warp_winner(best[r], flat);
      if (lane == 0 && flat != INT_MAX) atomicMin(&s_key[r], sweep_key(__int_as_float(mb), flat));
    }
  }
  __syncthreads();
  if (threadIdx.x < nr && s_key[threadIdx.x] != ~0ull) {
    atomicMin(keys + j0 + threadIdx.x, s_key[threadIdx.x]);
  }
  finish_tile(tile, j0, nr, splits, idx, keys, done, best_t, best_c, best_l);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(shared_addr(dst)), "l"(src) : "memory");
}

// Start the copy of one row into shared memory, 16 bytes a copy, and
// close the thread's group of copies.
template <typename T>
__device__ __forceinline__ void stage_cluster(T (*dst)[C], const T* __restrict__ row) {
  constexpr int PER_COPY = 16 / static_cast<int>(sizeof(T));  // elements a copy
  constexpr int COPIES = ROW / PER_COPY;
  for (int q = threadIdx.x; q < COPIES; q += blockDim.x) {
    cp_async16(&dst[0][0] + PER_COPY * q, row + PER_COPY * q);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ float quad(const float4& x, int q) {
  return q == 0 ? x.x : (q == 1 ? x.y : (q == 2 ? x.z : x.w));
}

// Rows staged for a block (mt_closest's layout, csrc/mt.cu). Block b
// takes ray tile b / splits of STAGED_TILE listed rays and cluster range
// [c0, c1) of split b % splits. Thread i takes ray i % STAGED_TILE
// against slice i / STAGED_TILE of each row, one slice a warp: the
// slices cut a row's 32 quads of triangles, slice s the quads s, s + S,
// ... The block stages the rows in shared memory with 16-byte cp.async,
// one at a time (a second buffer filled during the tests timed 4% slower
// at 2,048 rays: the other resident blocks hide the copy), and a thread
// reads four triangles of a component as one LDS.128 (a broadcast to the
// threads of the other rays). A quad whose four triangles all have a
// zero first edge is skipped, for the whole warp at once: with e0 = 0 the
// determinant is 0 or NaN, so no ray can hit it (the plain version tests
// it and rejects it), and the pads that fill a cluster's row past its
// triangles are such quads. A thread walks its triangles in ascending
// flat index and takes a hit only when strictly nearer than its ray's
// best so far (at first the best t at the call), so it holds the least
// (t, flat) of its share; the slices of a ray meet in a shared-memory
// atomicMin, and the block issues one atomicMin a ray with a hit. A
// thread past the tile's rays gets best t 0 and never hits.
template <typename T>
__global__ void __launch_bounds__(SWEEP_THREADS, 4)
wave_sweep_staged_kernel(const float* __restrict__ p, const float* __restrict__ d,
                         const T* __restrict__ table, int k, const int* __restrict__ idx,
                         int m, int splits, int per_block, float* best_t, int* best_c,
                         int* best_l, unsigned long long* keys, unsigned* done) {
  constexpr int RT = STAGED_TILE;
  constexpr int S = SWEEP_THREADS / RT;
  static_assert(RT == 32 && (C / 4) / S == 32 / 4, "a warp a slice, a lane a triangle of it");
  __shared__ __align__(16) T s[COMPS][C];
  __shared__ unsigned long long s_key[RT];
  const int tile = blockIdx.x / splits;
  const int j0 = tile * RT;
  const int nr = min(RT, m - j0);
  const int c0 = (blockIdx.x - tile * splits) * per_block;
  const int c1 = min(k, c0 + per_block);
  const int slot = threadIdx.x % RT;
  const int slice = threadIdx.x / RT;
  // the triangle of the slice this lane looks at for the quad mask:
  // quad j = lane / 4 of the slice, triangle lane % 4 of it
  const int mine = 4 * (slice + S * (slot >> 2)) + (slot & 3);
  stage_cluster(s, table + static_cast<size_t>(c0) * ROW);
  if (threadIdx.x < RT) s_key[threadIdx.x] = ~0ull;
  const int ray = slot < nr ? idx[j0 + slot] : -1;
  const float px = ray >= 0 ? p[3 * ray] : 0.f;
  const float py = ray >= 0 ? p[3 * ray + 1] : 0.f;
  const float pz = ray >= 0 ? p[3 * ray + 2] : 0.f;
  const float dx = ray >= 0 ? d[3 * ray] : 1.f;
  const float dy = ray >= 0 ? d[3 * ray + 1] : 1.f;
  const float dz = ray >= 0 ? d[3 * ray + 2] : 1.f;
  float bt = ray >= 0 ? best_t[ray] : 0.f;
  int bf = -1;
  for (int c = c0; c < c1; ++c) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // every thread's copies of this row have landed
    const T(*r)[C] = s;
    // bit 4 j set: quad j of the slice holds a triangle with e0 != 0
    unsigned quads = __ballot_sync(FULL, widen(r[3][mine]) != 0.0f ||
                                             widen(r[4][mine]) != 0.0f ||
                                             widen(r[5][mine]) != 0.0f);
    quads |= quads >> 1;
    quads |= quads >> 2;
    quads &= 0x11111111u;
#pragma unroll 1
    while (quads != 0) {
      const int i = 4 * (slice + S * ((__ffs(quads) - 1) >> 2));  // ascending
      quads &= quads - 1;
      const float4 ax = load4(&r[0][i]);
      const float4 ay = load4(&r[1][i]);
      const float4 az = load4(&r[2][i]);
      const float4 e0x = load4(&r[3][i]);
      const float4 e0y = load4(&r[4][i]);
      const float4 e0z = load4(&r[5][i]);
      const float4 e1x = load4(&r[6][i]);
      const float4 e1y = load4(&r[7][i]);
      const float4 e1z = load4(&r[8][i]);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        float t;
        if (mt_hit(quad(ax, w), quad(ay, w), quad(az, w), quad(e0x, w), quad(e0y, w),
                   quad(e0z, w), quad(e1x, w), quad(e1y, w), quad(e1z, w), px, py, pz, dx, dy,
                   dz, t) &&
            t < bt) {
          bt = t + 0.0f;  // -0.0 -> +0.0
          bf = c * C + i + w;
        }
      }
    }
    __syncthreads();  // the row is read: the next may be staged over it
    if (c + 1 < c1) stage_cluster(s, table + static_cast<size_t>(c + 1) * ROW);
  }
  if (bf >= 0) atomicMin(&s_key[slot], sweep_key(bt, bf));
  __syncthreads();
  if (threadIdx.x < nr && s_key[threadIdx.x] != ~0ull) {
    atomicMin(keys + j0 + threadIdx.x, s_key[threadIdx.x]);
  }
  finish_tile(tile, j0, nr, splits, idx, keys, done, best_t, best_c, best_l);
}

}  // namespace

// Plain C entry points for ctypes. Each launches on the given stream and
// returns the CUDA error code (0 = launched). Counts are > 0.

// idx (r,) int32 in [0, K); table (K, 9, 128) float32 contiguous and
// 16-byte aligned; out (r, 9, 128). staged != 0 takes the ring variant.
extern "C" int row_gather_launch(const int* idx, const float* table, int r, float* out,
                                 int staged, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (staged) {
    const int shared = STAGED_WARPS * NBUF * (ROW_BYTES + 8);
    const cudaError_t e = cudaFuncSetAttribute(
        row_gather_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int per_block = STAGED_WARPS * STAGED_ROWS;
    row_gather_staged_kernel<<<(r + per_block - 1) / per_block, STAGED_WARPS * 32, shared, s>>>(
        idx, table, r, out);
  } else {
    row_gather_direct_kernel<<<(r + GATHER_WARPS - 1) / GATHER_WARPS, GATHER_WARPS * 32, 0, s>>>(
        idx, table, r, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// wave_mt blocks (of MT_WARPS warps) resident on one SM of the current
// device for the row type (bf16 != 0: the __nv_bfloat16 instance): the
// host's gate plan reads it once a device and type.
extern "C" int wave_mt_blocks_per_sm(int bf16, int* blocks) {
  return static_cast<int>(
      bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 blocks, wave_mt_kernel<__nv_bfloat16>, MT_WARPS * 32, 0)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, wave_mt_kernel<float>,
                                                           MT_WARPS * 32, 0));
}

template <typename T>
int launch_wave_mt(const float* p, const float* d, const void* table, int k,
                   const float* col_t, const int* col_c, long long stride_t,
                   long long stride_c, int w, int any_hit, int n, int g, const int* order,
                   float* best_t, int* best_c, int* best_l, cudaStream_t s) {
  const int warps = (n + g - 1) / g;
  const int blocks = (warps + MT_WARPS - 1) / MT_WARPS;
  wave_mt_kernel<T><<<blocks, MT_WARPS * 32, 0, s>>>(
      p, d, static_cast<const T*>(table), k, col_t, col_c, stride_t, stride_c, w, any_hit, n,
      g, order, best_t, best_c, best_l);
  return static_cast<int>(cudaGetLastError());
}

// p, d (rays, 3); table (k, 9, 128) of float, or of bf16 when bf16 != 0;
// col_t, col_c: w columns a ray with unit column stride and the given row
// strides (in elements); best_t, best_c, best_l (rays,), updated in
// place; g (8, 16 or 32) rays a warp. Lanes run over n entries: rays
// 0..n-1 when order is null, else the n distinct rays order[0..n-1].
extern "C" int wave_mt_launch(const float* p, const float* d, const void* table, int bf16,
                              int k, const float* col_t, const int* col_c, long long stride_t,
                              long long stride_c, int w, int any_hit, int n, int g,
                              const int* order, float* best_t, int* best_c, int* best_l,
                              void* stream) {
  if (g != 8 && g != 16 && g != 32) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_wave_mt<__nv_bfloat16>(p, d, table, k, col_t, col_c, stride_t, stride_c,
                                              w, any_hit, n, g, order, best_t, best_c, best_l, s)
              : launch_wave_mt<float>(p, d, table, k, col_t, col_c, stride_t, stride_c, w,
                                      any_hit, n, g, order, best_t, best_c, best_l, s);
}

template <typename T>
int sweep_blocks_per_sm(int r, int* blocks) {
  switch (r) {
    case WARP_TILE:
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, wave_sweep_warp_kernel<T>, SWEEP_WARPS * 32, 0));
    case STAGED_TILE:
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, wave_sweep_staged_kernel<T>, SWEEP_THREADS, 0));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// wave_sweep blocks resident on one SM of the current device for a tile
// of r rays (4: a warp a tile; 32: rows staged for a block) and the row
// type: the host's sweep plan reads it once a device, tile and type.
extern "C" int wave_sweep_blocks_per_sm(int r, int bf16, int* blocks) {
  return bf16 ? sweep_blocks_per_sm<__nv_bfloat16>(r, blocks)
              : sweep_blocks_per_sm<float>(r, blocks);
}

template <typename T>
int launch_wave_sweep(const float* p, const float* d, const void* table, int k,
                      const int* idx, int m, int r, int splits, int per_block, float* best_t,
                      int* best_c, int* best_l, unsigned long long* keys, unsigned* done,
                      cudaStream_t s) {
  const T* rows = static_cast<const T*>(table);
  switch (r) {
    case WARP_TILE: {
      const unsigned blocks = static_cast<unsigned>((m + WARP_TILE - 1) / WARP_TILE) * splits;
      wave_sweep_warp_kernel<T><<<blocks, SWEEP_WARPS * 32, 0, s>>>(
          p, d, rows, k, idx, m, splits, per_block, best_t, best_c, best_l, keys, done);
      return static_cast<int>(cudaGetLastError());
    }
    case STAGED_TILE: {
      const unsigned blocks = static_cast<unsigned>((m + STAGED_TILE - 1) / STAGED_TILE) * splits;
      wave_sweep_staged_kernel<T><<<blocks, SWEEP_THREADS, 0, s>>>(
          p, d, rows, k, idx, m, splits, per_block, best_t, best_c, best_l, keys, done);
      return static_cast<int>(cudaGetLastError());
    }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// idx (m,) int32 rays to sweep, in tiles of r (4 or 32); the
// clusters cut into splits ranges of per_block (the last may be short,
// none empty); the table and the state as in wave_mt. keys (at least m)
// and done (at least ceil(m / r)) are the sweep's own: every key ~0 and
// every counter 0 before the first call, and every call leaves them so.
// One launch. k * 128 must fit an int32.
extern "C" int wave_sweep_launch(const float* p, const float* d, const void* table, int bf16,
                                 int k, const int* idx, int m, int r, int splits, int per_block,
                                 float* best_t, int* best_c, int* best_l,
                                 unsigned long long* keys, unsigned* done, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || per_block < 1 || static_cast<long long>(splits - 1) * per_block >= k ||
      static_cast<long long>(splits) * per_block < k) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return bf16 ? launch_wave_sweep<__nv_bfloat16>(p, d, table, k, idx, m, r, splits, per_block,
                                                 best_t, best_c, best_l, keys, done, s)
              : launch_wave_sweep<float>(p, d, table, k, idx, m, r, splits, per_block, best_t,
                                         best_c, best_l, keys, done, s);
}
