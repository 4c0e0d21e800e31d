// Front-table kernels of the cluster tracer for Hopper (sm_90a).
//
// front_full replaces the Pallas TPU kernel phosphorus_mk2_tpu/accel/
// pallas_front.py:136 (_kernel_full, reached through front_all_pallas):
// for every ray, the slab test against all K2 supercluster boxes, the
// jj nearest parents as packed keys, and the slab test of each valid
// parent's SC member boxes as packed candidate keys. front_slab_extract
// replaces pallas_front.py:36 (_kernel, reached through
// slab_extract_pallas): the first two of those stages alone. The two
// are one template here, as the second Pallas kernel repeats the first
// two stages of the other. The Python wrappers, the key decoding and the
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
//            through a float operation). jj rounds of min over the row,
//            each killing its winner with 0x7FFFFFFF. Parent j is valid
//            when (key & mask) < (bits(3.4e38) & mask).
//   stage 3  for a valid parent, its SC member boxes are read by parent
//            id from the (K2, SC, 3) tables; hit = tn2 <= tf2 &&
//            tf2 >= 0 && tn2 < tlim && tn2 < 1e37 on the RAW tn2 (the
//            clamp comes AFTER the limit test here); candidate key =
//            (bits(hit ? max(tn2, 0) : 3.4e38) & -(1 << nbits_c)) |
//            (j * SC + s).
//
// NaN rule. Empty slots of every table hold NaN bounds, and a NaN must
// make the box a miss. fminf/fmaxf return the OTHER operand on a NaN,
// which would turn such a slot into an infinite interval that hits every
// ray; nan_min/nan_max below propagate it, as torch.minimum/maximum and
// the reference's minimum/maximum do, so tn is NaN and tn <= tf is
// false. Member slots keep their NaN (the Pallas wrapper rewrites them
// to far point boxes only because its one-hot matmul cannot carry NaN).
//
// What bounds them on an H100: a ray costs K2 slab tests of about 28
// float32 operations each, jj * K2 integer compares for the extraction
// and SC member slabs per valid parent, against 28 bytes in and
// (jj + jj * SC) * 4 bytes out. At K2 = 363, jj = 16, SC = 16 that is
// ~16,000 operations and ~1.1 KB a ray, and the two bounds lie close:
// front_full is bound by the bytes of its 272 output keys a ray,
// front_slab_extract (16 keys out) by its operations. The extraction is a
// chain of jj dependent rounds (a warp reduction, then a rescan by one
// lane), which neither bound counts.
//
// What the design does about it: one warp per ray. A block stages the
// bounds table once in shared memory as six rows (conflict-free when the
// lanes stride the columns) and its warps walk several rays each. A lane
// owns the columns congruent to its index: it writes their keys into its
// warp's shared row and keeps their minimum in a register, so a round of
// the extraction is one __reduce_min_sync and a rescan by the one lane
// that held the winner. Keys are unique (the column rides in the low
// bits), so exactly one entry dies per round, as in the reference. The
// member expansion spreads the jj * SC boxes over the 32 lanes and writes
// the candidate keys coalesced. No matrix product routes geometry.
//
// Exactness: compiled with --fmad=false and IEEE division, no fast math.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;           // warps (rays in flight) per block
constexpr int RAYS_PER_WARP = 4;   // rays a warp walks, one after the other
constexpr int BLOCK = WARPS * 32;
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

// One axis of a slab test folded into the running interval [tn, tf].
__device__ __forceinline__ void slab_axis(float bmin, float bmax, float p,
                                          float inv, float& tn, float& tf) {
  const float t0 = (bmin - p) * inv;
  const float t1 = (bmax - p) * inv;
  tn = nan_max(tn, nan_min(t0, t1));
  tf = nan_min(tf, nan_max(t0, t1));
}

// Dynamic shared memory: [6][k2] float bounds rows (bmin xyz, bmax xyz),
// then per warp a row of k2 int keys, then per warp jj int parent keys.
template <bool EXPAND>
__global__ void __launch_bounds__(BLOCK)
front_kernel(const float* __restrict__ sc_bmin, const float* __restrict__ sc_bmax,
             const float* __restrict__ mb_min, const float* __restrict__ mb_max,
             const float* __restrict__ p, const float* __restrict__ d,
             const float* __restrict__ tlim, int n, int k2, int jj, int sc,
             int nbits_p, int nbits_c, int* __restrict__ out_p,
             int* __restrict__ out_c) {
  extern __shared__ float smem[];
  float* sb = smem;                                       // [6][k2]
  int* skeys = reinterpret_cast<int*>(smem + 6 * k2);     // [WARPS][k2]
  int* spar = skeys + WARPS * k2;                         // [WARPS][jj]

  for (int i = threadIdx.x; i < 3 * k2; i += BLOCK) {
    const int k = i / 3;
    const int a = i % 3;
    sb[a * k2 + k] = sc_bmin[i];
    sb[(3 + a) * k2 + k] = sc_bmax[i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* keys = skeys + warp * k2;
  int* par = spar + warp * jj;
  const int mask_p = -(1 << nbits_p);
  const int idmask_p = (1 << nbits_p) - 1;
  const int tmax_key_p = __float_as_int(T_MAX) & mask_p;
  const int mask_c = -(1 << nbits_c);

  for (int r = 0; r < RAYS_PER_WARP; ++r) {
    const int ray = (blockIdx.x * RAYS_PER_WARP + r) * WARPS + warp;
    if (ray >= n) break;  // uniform over the warp
    const float px = p[3 * ray], py = p[3 * ray + 1], pz = p[3 * ray + 2];
    const float dx = d[3 * ray], dy = d[3 * ray + 1], dz = d[3 * ray + 2];
    const float tl = tlim[ray];
    const float ix = 1.0f / (dx == 0.0f ? 1e-30f : dx);
    const float iy = 1.0f / (dy == 0.0f ? 1e-30f : dy);
    const float iz = 1.0f / (dz == 0.0f ? 1e-30f : dz);

    // stage 1: slab of the lane's columns, packed keys, the lane's minimum
    int lmin = DEAD;
    for (int k = lane; k < k2; k += 32) {
      float tn = -T_MAX, tf = T_MAX;
      slab_axis(sb[k], sb[3 * k2 + k], px, ix, tn, tf);
      slab_axis(sb[k2 + k], sb[4 * k2 + k], py, iy, tn, tf);
      slab_axis(sb[2 * k2 + k], sb[5 * k2 + k], pz, iz, tn, tf);
      const float tnc = clamp0(tn);
      const bool pending = (tn <= tf) && (tf >= 0.0f) && (tnc < tl);
      const int key = (__float_as_int(pending ? tnc : T_MAX) & mask_p) | k;
      keys[k] = key;
      lmin = min(lmin, key);
    }

    // stage 2: jj rounds of min-extraction in the signed int32 domain
    for (int j = 0; j < jj; ++j) {
      const int m = __reduce_min_sync(FULL, lmin);
      const int col = m & idmask_p;
      if ((col & 31) == lane) {  // the one lane that owns the winner
        keys[col] = DEAD;
        par[j] = m;
        lmin = DEAD;
        for (int k = lane; k < k2; k += 32) lmin = min(lmin, keys[k]);
      }
    }
    __syncwarp();
    for (int j = lane; j < jj; j += 32) out_p[static_cast<size_t>(ray) * jj + j] = par[j];

    // stage 3: member boxes of the valid parents, gathered by parent id
    if constexpr (EXPAND) {
      const int width = jj * sc;
      for (int c = lane; c < width; c += 32) {
        const int j = c / sc;
        const int s = c - j * sc;
        const int m = par[j];
        float cand = T_MAX;
        if ((m & mask_p) < tmax_key_p) {
          const size_t row = (static_cast<size_t>(m & idmask_p) * sc + s) * 3;
          float tn = -T_MAX, tf = T_MAX;
          slab_axis(mb_min[row], mb_max[row], px, ix, tn, tf);
          slab_axis(mb_min[row + 1], mb_max[row + 1], py, iy, tn, tf);
          slab_axis(mb_min[row + 2], mb_max[row + 2], pz, iz, tn, tf);
          const bool hit = (tn <= tf) && (tf >= 0.0f) && (tn < tl) && (tn < 1e37f);
          if (hit) cand = clamp0(tn);
        }
        out_c[static_cast<size_t>(ray) * width + c] = (__float_as_int(cand) & mask_c) | c;
      }
    }
    __syncwarp();  // par and keys are rewritten for the next ray
  }
}

template <bool EXPAND>
int launch(const float* sc_bmin, const float* sc_bmax, const float* mb_min,
           const float* mb_max, const float* p, const float* d, const float* tlim,
           int n, int k2, int jj, int sc, int nbits_p, int nbits_c, int* out_p,
           int* out_c, void* stream) {
  const size_t shared = (static_cast<size_t>(6 + WARPS) * k2 + WARPS * jj) * 4;
  if (shared > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        front_kernel<EXPAND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int rays_per_block = WARPS * RAYS_PER_WARP;
  const int grid = (n + rays_per_block - 1) / rays_per_block;
  front_kernel<EXPAND><<<grid, BLOCK, shared, static_cast<cudaStream_t>(stream)>>>(
      sc_bmin, sc_bmax, mb_min, mb_max, p, d, tlim, n, k2, jj, sc, nbits_p,
      nbits_c, out_p, out_c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Each launches on the given stream and
// returns the CUDA error code (0 = launched). n > 0, 1 <= jj <= k2.
//
// sc_bmin, sc_bmax: (k2, 3) supercluster bounds; mb_min, mb_max:
// (k2, sc, 3) member bounds; p, d: (n, 3); tlim: (n,); out_p: (n, jj)
// packed parent keys; out_c: (n, jj * sc) packed candidate keys.
extern "C" int front_full_launch(const float* sc_bmin, const float* sc_bmax,
                                 const float* mb_min, const float* mb_max,
                                 const float* p, const float* d, const float* tlim,
                                 int n, int k2, int jj, int sc, int nbits_p,
                                 int nbits_c, int* out_p, int* out_c, void* stream) {
  return launch<true>(sc_bmin, sc_bmax, mb_min, mb_max, p, d, tlim, n, k2, jj, sc,
                      nbits_p, nbits_c, out_p, out_c, stream);
}

extern "C" int front_slab_extract_launch(const float* sc_bmin, const float* sc_bmax,
                                         const float* p, const float* d,
                                         const float* tlim, int n, int k2, int jj,
                                         int nbits_p, int* out_p, void* stream) {
  return launch<false>(sc_bmin, sc_bmax, nullptr, nullptr, p, d, tlim, n, k2, jj, 1,
                       nbits_p, 1, out_p, nullptr, stream);
}
