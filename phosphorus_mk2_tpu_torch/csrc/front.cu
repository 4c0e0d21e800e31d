// Front-table kernels of the cluster tracer for Hopper (sm_90a).
//
// front_full replaces the Pallas TPU kernel phosphorus_mk2_tpu/accel/
// pallas_front.py:136 (_kernel_full, reached through front_all_pallas),
// together with the row sort that front_all_pallas runs on its output:
// for every ray, the slab test against all K2 supercluster boxes, the jj
// nearest parents as packed keys, the slab test of each valid parent's
// SC member boxes as packed candidate keys, and of those the kk smallest
// in ascending order (or, given kk = 0, all jj * SC of them by column).
// front_slab_extract replaces pallas_front.py:36 (_kernel, reached through
// slab_extract_pallas): the first two of those stages alone. The two are
// one template here, as the second Pallas kernel repeats the first two
// stages of the other. The Python wrappers, the key decoding and the
// plain PyTorch versions they are held against live in accel/front.py.
//
// What is computed (all of it to the bit of the plain version):
//   stage 1  inv = 1 / (d == 0 ? 1e-30 : d) per axis; per box
//            t0 = (bmin - p) * inv, t1 = (bmax - p) * inv,
//            tn = max(-3.4e38, min(t0, t1) ...), tf = min(3.4e38,
//            max(t0, t1) ...); tnc = max(tn, 0), its zero always +0.0;
//            pending = tn <= tf && tf >= 0 && tnc < tlim (the clamp comes
//            BEFORE the limit test here); key value tnc or 3.4e38.
//   stage 2  packed key = (float bits & -(1 << nbits_p)) | column, an
//            int32 (keys are non-negative floats, so int order is float
//            order; a key of tn = 0 is a float denormal and never passes
//            through a float operation). The jj smallest in ascending
//            order. Parent j is valid when (key & mask) < (bits(3.4e38) &
//            mask).
//   stage 3  for a valid parent, its SC member boxes are read by parent
//            id from the (K2, SC, 3) tables; hit = tn2 <= tf2 &&
//            tf2 >= 0 && tn2 < tlim && tn2 < 1e37 on the RAW tn2 (the
//            clamp comes AFTER the limit test here); candidate key =
//            (bits(hit ? max(tn2, 0) : 3.4e38) & -(1 << nbits_c)) |
//            (j * SC + s). The kk smallest in ascending order: keys are
//            unique (the column rides in the low bits), so that is
//            sort(keys)[:kk] of the row to the bit.
//
// NaN rule. Empty slots of every table hold NaN bounds, and a NaN must
// make the box a miss (fminf/fmaxf return the OTHER operand on a NaN,
// which would turn such a slot into an infinite interval that hits every
// ray). A supercluster box with a NaN bound is rewritten to +inf on all
// six bounds as the block stages the table; a member box with a NaN bound
// is a miss by test. Both always miss, for any ray, as the NaN box does
// in the plain version (torch.minimum/maximum propagate NaN, so tn is NaN
// and tn <= tf is false): their keys are equal. With finite bounds, a
// finite origin and a finite, non-zero inv (d == 0 is replaced), t0 and
// t1 are never NaN, so fminf/fmaxf equal the NaN-propagating min/max bit
// for bit and the slab needs no NaN test. A ray whose origin or inv is
// not finite, or whose inv is 0 (a denormal direction component makes inv
// infinite, an infinite one makes it 0, and 0 * inf is NaN), takes the
// NaN-propagating nan_min/nan_max of the plain version: the branch is
// uniform over its warp.
//
// What bounds them on an H100: a ray costs K2 slab tests of about 28
// float32 operations each, the selections and SC member slabs per valid
// parent, against 28 bytes in and (jj + kk) * 4 bytes out (front_full;
// jj * 4 for front_slab_extract). At K2 = 363, jj = 16, SC = 16, kk = 32
// that is ~17,000 operations and ~220 bytes a ray: both kernels are
// bound by their operations. The selections are chains of dependent
// rounds, which neither bound counts.
//
// What the design does about it: one warp per ray. A block stages the
// bounds table once in shared memory as six rows (conflict-free when the
// lanes stride the columns) and its warps walk several rays each. A lane
// owns the columns congruent to its index. A key is either pending (its
// box is ahead within the limit) or far, and a far key is the bits of
// 3.4e38 with its column: far keys sort after every pending one and among
// themselves by column, so they need no selection at all. A lane keeps
// the WIN smallest of its pending keys sorted in registers (an insertion
// into a sorted window) and a bit per column that says which are
// pending. A round of a selection is one __reduce_min_sync over the
// lanes' heads and a pop of the winning lane's head (keys are unique, so
// exactly one lane pops), and there are only as many rounds as pending
// keys, up to jj or kk; the far columns then fill the rest in column
// order, each warp-wide step one ballot and a prefix count. A lane whose
// window runs dry while it still owns pending keys refills it by
// recomputing its keys and keeping the pending ones above the last it
// gave (all of its remaining keys lie above it): with K2 <= 768, 24 keys
// a lane, that takes 9 of a ray's 16 nearest pending superclusters in one
// lane of 32, and costs one more slab pass of that lane when it happens.
// The candidate stage does the same with the jj * SC member keys, spread
// over the lanes, and writes the kk keys coalesced: 128 bytes a ray at
// kk = 32 where the whole row was 1,024. No matrix product routes
// geometry.
//
// Exactness: compiled with --fmad=false and IEEE division, no fast math.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;           // warps (rays in flight) per block
constexpr int RAYS_PER_WARP = 4;   // rays a warp walks, one after the other
constexpr int BLOCK = WARPS * 32;
constexpr int WIN = 8;             // keys a lane keeps sorted in registers
constexpr float T_MAX = 3.4e38f;
constexpr int DEAD = 0x7FFFFFFF;   // above any packed key
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

// max(t, 0) that keeps a NaN and gives +0.0 for -0.0: the bits of -0.0
// would be a negative key that sorts before every +0.0 key.
__device__ __forceinline__ float clamp0(float t) {
  return (t != t) ? t : ((t > 0.0f) ? t : 0.0f);
}

// One axis of a slab test folded into the running interval [tn, tf]; FAST
// when no operand can be NaN (see the NaN rule above).
template <bool FAST>
__device__ __forceinline__ void slab_axis(float bmin, float bmax, float p,
                                          float inv, float& tn, float& tf) {
  const float t0 = (bmin - p) * inv;
  const float t1 = (bmax - p) * inv;
  if constexpr (FAST) {
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
  } else {
    tn = nan_max(tn, nan_min(t0, t1));
    tf = nan_min(tf, nan_max(t0, t1));
  }
}

// A lane's window: the WIN smallest keys it has seen, ascending, DEAD
// above them. Inserting shifts the larger entries up by one and drops the
// largest; the top-down order reads each old entry before it is moved.
__device__ __forceinline__ void insert(int (&win)[WIN], int key) {
#pragma unroll
  for (int i = WIN - 1; i > 0; --i) win[i] = (key < win[i - 1]) ? win[i - 1] : min(win[i], key);
  win[0] = min(win[0], key);
}

__device__ __forceinline__ void pop(int (&win)[WIN]) {
#pragma unroll
  for (int i = 0; i < WIN - 1; ++i) win[i] = win[i + 1];
  win[WIN - 1] = DEAD;
}

// The rays' shared inputs of one warp's ray.
struct Ray {
  float px, py, pz, ix, iy, iz, tl;
};

// Stage 1 of column k from the staged rows: its packed parent key.
template <bool FAST>
__device__ __forceinline__ int parent_key(const float* sb, int k2, int k, const Ray& r,
                                          int mask_p) {
  float tn = -T_MAX, tf = T_MAX;
  slab_axis<FAST>(sb[k], sb[3 * k2 + k], r.px, r.ix, tn, tf);
  slab_axis<FAST>(sb[k2 + k], sb[4 * k2 + k], r.py, r.iy, tn, tf);
  slab_axis<FAST>(sb[2 * k2 + k], sb[5 * k2 + k], r.pz, r.iz, tn, tf);
  const float tnc = clamp0(tn);
  const bool pending = (tn <= tf) && (tf >= 0.0f) && (tnc < r.tl);
  return (__float_as_int(pending ? tnc : T_MAX) & mask_p) | k;
}

// Stage 3 of candidate column c: its packed key, from the parent keys.
template <bool FAST>
__device__ __forceinline__ int cand_key(const float* __restrict__ mb_min,
                                        const float* __restrict__ mb_max, const int* par,
                                        int c, int sc, const Ray& r, int mask_p, int idmask_p,
                                        int tmax_key_p, int mask_c) {
  const int j = c / sc;
  const int s = c - j * sc;
  const int m = par[j];
  float cand = T_MAX;
  if ((m & mask_p) < tmax_key_p) {
    const size_t row = (static_cast<size_t>(m & idmask_p) * sc + s) * 3;
    const float x0 = mb_min[row], y0 = mb_min[row + 1], z0 = mb_min[row + 2];
    const float x1 = mb_max[row], y1 = mb_max[row + 1], z1 = mb_max[row + 2];
    const bool empty = (x0 != x0) || (y0 != y0) || (z0 != z0) || (x1 != x1) ||
                       (y1 != y1) || (z1 != z1);  // a NaN slot is a miss
    if (!empty) {
      float tn = -T_MAX, tf = T_MAX;
      slab_axis<FAST>(x0, x1, r.px, r.ix, tn, tf);
      slab_axis<FAST>(y0, y1, r.py, r.iy, tn, tf);
      slab_axis<FAST>(z0, z1, r.pz, r.iz, tn, tf);
      const bool hit = (tn <= tf) && (tf >= 0.0f) && (tn < r.tl) && (tn < 1e37f);
      if (hit) cand = clamp0(tn);
    }
  }
  return (__float_as_int(cand) & mask_c) | c;
}

// The smallest `rounds` keys of the lane-strided columns [0, width), in
// ascending order, into out[0, rounds) (a row in shared or device
// memory); key_of(c) is the key of column c. A key below `far` is
// pending; every other key is far | c (a box the ray does not reach), so
// those follow the pending keys in column order and need no selection:
// min(P, rounds) rounds pop the P pending keys from the lanes' windows,
// and ballots over the columns place the far ones after them.
template <typename KeyOf>
__device__ __forceinline__ void select_smallest(int width, int rounds, int lane, int far,
                                                KeyOf key_of, int* out) {
  int win[WIN];
#pragma unroll
  for (int i = 0; i < WIN; ++i) win[i] = DEAD;
  int left = 0;                // the lane's pending keys not yet given
  unsigned long long near = 0; // bit i: column lane + 32 i is pending (i < 64)
  for (int i = 0, c = lane; c < width; ++i, c += 32) {
    const int key = key_of(c);
    if (key < far) {
      ++left;
      if (i < 64) near |= 1ull << i;
      if (key < win[WIN - 1]) insert(win, key);
    }
  }
  const int popped = min(__reduce_add_sync(FULL, left), rounds);
  int held = 0;  // lane i holds round 32 q + i until its batch is written
  for (int r = 0; r < popped; ++r) {
    const int m = __reduce_min_sync(FULL, win[0]);
    if ((r & 31) == lane) held = m;
    if (((r & 31) == 31 || r == popped - 1) && lane <= (r & 31)) out[(r & ~31) + lane] = held;
    if (win[0] == m) {  // the one lane that held it
      pop(win);
      --left;
      if (win[0] == DEAD && left > 0) {  // refill: its pending keys above m
        for (int c = lane; c < width; c += 32) {
          const int key = key_of(c);
          if (key < far && key > m && key < win[WIN - 1]) insert(win, key);
        }
      }
    }
  }
  const unsigned below = (1u << lane) - 1u;
  for (int i = 0, pos = popped; pos < rounds && 32 * i < width; ++i) {  // uniform
    const int c = 32 * i + lane;
    bool is_far = false;
    if (c < width) is_far = (i < 64) ? !((near >> i) & 1ull) : key_of(c) >= far;
    const unsigned b = __ballot_sync(FULL, is_far);
    const int at = pos + __popc(b & below);
    if (is_far && at < rounds) out[at] = far | c;
    pos += __popc(b);
  }
}

// One ray of one warp: the three stages. par is the warp's row of jj
// parent keys in shared memory.
template <bool EXPAND, bool FAST>
__device__ __forceinline__ void front_ray(const float* sb, const float* __restrict__ mb_min,
                                          const float* __restrict__ mb_max, const Ray& r,
                                          int ray, int lane, int k2, int jj, int sc, int kk,
                                          int nbits_p, int nbits_c, int* par,
                                          int* __restrict__ out_p, int* __restrict__ out_c) {
  const int mask_p = -(1 << nbits_p);
  const int idmask_p = (1 << nbits_p) - 1;
  const int tmax_key_p = __float_as_int(T_MAX) & mask_p;
  const int mask_c = -(1 << nbits_c);

  // stages 1 and 2: the jj smallest parent keys
  select_smallest(k2, jj, lane, tmax_key_p,
                  [&](int k) { return parent_key<FAST>(sb, k2, k, r, mask_p); }, par);
  __syncwarp();
  for (int j = lane; j < jj; j += 32) out_p[static_cast<size_t>(ray) * jj + j] = par[j];

  if constexpr (EXPAND) {
    const int width = jj * sc;
    auto key_of = [&](int c) {
      return cand_key<FAST>(mb_min, mb_max, par, c, sc, r, mask_p, idmask_p, tmax_key_p,
                            mask_c);
    };
    if (kk == 0) {  // every candidate key, by column
      for (int c = lane; c < width; c += 32) out_c[static_cast<size_t>(ray) * width + c] = key_of(c);
    } else {  // the kk smallest, ascending
      const int rounds = min(kk, width);
      select_smallest(width, rounds, lane, __float_as_int(T_MAX) & mask_c, key_of,
                      out_c + static_cast<size_t>(ray) * rounds);
    }
  }
  __syncwarp();  // par is rewritten for the next ray
}

// Dynamic shared memory: [6][k2] float bounds rows (bmin xyz, bmax xyz),
// then per warp jj int parent keys.
template <bool EXPAND>
__global__ void __launch_bounds__(BLOCK)
front_kernel(const float* __restrict__ sc_bmin, const float* __restrict__ sc_bmax,
             const float* __restrict__ mb_min, const float* __restrict__ mb_max,
             const float* __restrict__ p, const float* __restrict__ d,
             const float* __restrict__ tlim, int n, int k2, int jj, int sc, int kk,
             int nbits_p, int nbits_c, int* __restrict__ out_p, int* __restrict__ out_c) {
  extern __shared__ float smem[];
  float* sb = smem;                                       // [6][k2]
  int* spar = reinterpret_cast<int*>(smem + 6 * k2);      // [WARPS][jj]

  const float inf = __int_as_float(0x7F800000);
  for (int k = threadIdx.x; k < k2; k += BLOCK) {
    float b[6];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      b[a] = sc_bmin[3 * k + a];
      b[3 + a] = sc_bmax[3 * k + a];
    }
    bool empty = false;
#pragma unroll
    for (int a = 0; a < 6; ++a) empty |= (b[a] != b[a]);
#pragma unroll
    for (int a = 0; a < 6; ++a) sb[a * k2 + k] = empty ? inf : b[a];  // always a miss
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* par = spar + warp * jj;
  for (int i = 0; i < RAYS_PER_WARP; ++i) {
    const int ray = (blockIdx.x * RAYS_PER_WARP + i) * WARPS + warp;
    if (ray >= n) break;  // uniform over the warp
    Ray r;
    r.px = p[3 * ray], r.py = p[3 * ray + 1], r.pz = p[3 * ray + 2];
    const float dx = d[3 * ray], dy = d[3 * ray + 1], dz = d[3 * ray + 2];
    r.tl = tlim[ray];
    r.ix = 1.0f / (dx == 0.0f ? 1e-30f : dx);
    r.iy = 1.0f / (dy == 0.0f ? 1e-30f : dy);
    r.iz = 1.0f / (dz == 0.0f ? 1e-30f : dz);
    // an infinite d gives inv = 0, and 0 * inf is NaN: not fast either
    const bool fast = isfinite(r.px) && isfinite(r.py) && isfinite(r.pz) && isfinite(r.ix) &&
                      isfinite(r.iy) && isfinite(r.iz) && r.ix != 0.0f && r.iy != 0.0f &&
                      r.iz != 0.0f;
    if (fast) {
      front_ray<EXPAND, true>(sb, mb_min, mb_max, r, ray, lane, k2, jj, sc, kk, nbits_p,
                              nbits_c, par, out_p, out_c);
    } else {
      front_ray<EXPAND, false>(sb, mb_min, mb_max, r, ray, lane, k2, jj, sc, kk, nbits_p,
                               nbits_c, par, out_p, out_c);
    }
  }
}

template <bool EXPAND>
int launch(const float* sc_bmin, const float* sc_bmax, const float* mb_min,
           const float* mb_max, const float* p, const float* d, const float* tlim,
           int n, int k2, int jj, int sc, int kk, int nbits_p, int nbits_c, int* out_p,
           int* out_c, void* stream) {
  const size_t shared = (static_cast<size_t>(6) * k2 + WARPS * jj) * 4;
  if (shared > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        front_kernel<EXPAND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int rays_per_block = WARPS * RAYS_PER_WARP;
  const int grid = (n + rays_per_block - 1) / rays_per_block;
  front_kernel<EXPAND><<<grid, BLOCK, shared, static_cast<cudaStream_t>(stream)>>>(
      sc_bmin, sc_bmax, mb_min, mb_max, p, d, tlim, n, k2, jj, sc, kk, nbits_p,
      nbits_c, out_p, out_c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Each launches on the given stream and
// returns the CUDA error code (0 = launched). n > 0, 1 <= jj <= k2.
//
// sc_bmin, sc_bmax: (k2, 3) supercluster bounds; mb_min, mb_max:
// (k2, sc, 3) member bounds; p, d: (n, 3); tlim: (n,); out_p: (n, jj)
// packed parent keys; out_c: (n, min(kk, jj * sc)) packed candidate keys
// ascending, or (n, jj * sc) by column when kk = 0.
extern "C" int front_full_launch(const float* sc_bmin, const float* sc_bmax,
                                 const float* mb_min, const float* mb_max,
                                 const float* p, const float* d, const float* tlim,
                                 int n, int k2, int jj, int sc, int kk, int nbits_p,
                                 int nbits_c, int* out_p, int* out_c, void* stream) {
  if (kk < 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(sc_bmin, sc_bmax, mb_min, mb_max, p, d, tlim, n, k2, jj, sc, kk,
                      nbits_p, nbits_c, out_p, out_c, stream);
}

extern "C" int front_slab_extract_launch(const float* sc_bmin, const float* sc_bmax,
                                         const float* p, const float* d,
                                         const float* tlim, int n, int k2, int jj,
                                         int nbits_p, int* out_p, void* stream) {
  return launch<false>(sc_bmin, sc_bmax, nullptr, nullptr, p, d, tlim, n, k2, jj, 1, 0,
                       nbits_p, 1, out_p, nullptr, stream);
}
