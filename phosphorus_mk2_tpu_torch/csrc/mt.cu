// Brute-force Moller-Trumbore ray-triangle kernels for Hopper (sm_90a).
//
// mt_closest replaces the Pallas TPU kernel phosphorus_mk2_tpu/accel/
// pallas_mt.py:29 (_mt_kernel, reached through intersect_pallas_brute);
// mt_anyhit replaces pallas_mt.py:186 (_anyhit_kernel, reached through
// occluded_pallas_brute). The Python wrappers, the launch plan and the
// plain PyTorch versions they are held against live in accel/mt.py.
//
// Table layout (the Pallas kernels' own): a (10, tp) float32 row-major
// table with tp a multiple of 512; rows are ax ay az e0x e0y e0z e1x e1y
// e1z and, in row 9, the triangle id as int32 bits (-1 on pad columns,
// whose zero edges fail the determinant test anyway). The caller passes
// cols, the columns that can hold a triangle (every later column is a
// pad): both kernels stop at the last tile that reaches into them, so a
// table padded to 512 columns for 36 triangles costs one tile, not eight.
//
// What bounds them on an H100: operations. Every test of a ray against
// a triangle is ~46 FP32 operations and one IEEE division, so N rays x T
// triangles (T counts the columns that hold one; a pad is settled by its
// id) are ~46 N T operations against 40 (N + T) bytes of input: at
// 65,536 rays x 4,812 triangles, 14.5 GFLOP against 2.8 MB. The stated
// bound (67 TFLOP/s) counts an FMA as two operations, but this file is
// compiled without contraction: a test issues ~77 instructions as
// compiled (chip_smoke.py counts them in the SASS of the inner loop: 47
// FP32 multiplies and adds, 7 compares, the division's reciprocal with
// its range check and branch, the update), one warp-instruction per 32
// tests, at most 4 a clock on an SM. That issue floor is ~30% of the
// stated bound's rate, and only the layout of the work can approach it.
//
// mt_closest, the design:
//   * One thread holds CR rays; a block of CB threads owns a ray tile of
//     CB * CR rays and walks a range of the table's CT-column tiles. A
//     triangle read from shared memory feeds CR tests, and a read is a
//     broadcast LDS.128 of four consecutive columns of one component:
//     nine loads serve 4 x CR tests (the first design: ten a test).
//   * The column range is cut over gridDim.y splits so that the grid
//     holds about four waves of resident blocks whatever the ray count
//     (accel/mt.py closest_plan, from the SM count and this kernel's
//     occupancy; one wave of blocks ran slower than four). A thread keeps,
//     for each of its rays, the least (t, column) of its range: it walks
//     the columns in ascending order and takes a hit only when t < best
//     strictly. The splits meet in a 64-bit atomicMin of
//     (t bits << 32 | column), as wave_sweep's do (csrc/wave.cu): the
//     least (t, column) over valid hits is a property of the set, not of
//     the order, so any split gives the unsplit winner. With one split
//     the key is stored as it is.
//   * A finishing kernel decodes each key, recomputes u and v of the
//     winning column with the same mt_test (same operations, same order:
//     bit-equal to the plain version's), and writes t, tri (the id bits of
//     that column), u and v; a miss is T_MAX, -1, 0, 0.
//   * A winning t of -0.0 (a ray that starts on a triangle) is stored as
//     +0.0, t + 0.0f: its bits would otherwise be the largest key.
//   * Two rays a thread and not four: four took 96 registers and fewer
//     resident blocks, and timed slower at 65,536 rays and no faster at
//     262,144: the warps matter more here than the shared loads.
//
// mt_anyhit, the design: the work follows the tests the rays need.
//   * A block owns AR rays and walks the table in AT-column tiles. It
//     keeps its still-live rays (tmax > 0, NaN excluded, and not yet
//     occluded) as a compacted list in shared memory, rebuilt after each
//     tile by a ballot and a popcount prefix, and leaves when the list is
//     empty.
//   * Each warp loads the tile into registers, lane l holding columns l,
//     l + 32, l + 64 and l + 96, then takes live rays from the list in
//     turn: the ray is broadcast from shared memory, every lane tests its
//     four triangles, and one __any_sync decides the ray. A warp's lanes
//     are never idle on a dead ray, and a ray costs at most the rest of
//     the tile that holds its first occluder (the first design ran each
//     warp until its last ray was done, so it tested all pairs).
//
// Both kernels stage a tile with 16-byte cp.async copies, once the tile
// before has been tested: a second buffer filled during the tests bought
// nothing, as the staged ring bought nothing for row_gather
// (csrc/wave.cu); the other resident blocks hide the copy.
//
// Exactness: the file is compiled with --fmad=false and IEEE division
// (no fast math), so every operation rounds as the plain PyTorch version
// rounds it, in the same order, and t/tri match it bit for bit. The
// closest-hit rule is the Pallas kernel's: the minimum t, and on a tie
// the lowest column.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ROWS = 10;
constexpr float T_MAX = 3.4e38f;
constexpr float DET_EPS = 1e-8f;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned long long NO_HIT = ~0ull;

constexpr int CT = 64;         // mt_closest: columns of a tile (staging and split unit)
constexpr int CB = 128;        // mt_closest: threads of a block
constexpr int CR = 2;          // mt_closest: rays of a thread
constexpr int FINISH = 256;    // mt_closest: threads of a finishing block

constexpr int AT = 128;        // mt_anyhit: columns of a tile
constexpr int AW = 4;          // mt_anyhit: warps of a block
constexpr int AR = 128;        // mt_anyhit: rays of a block
constexpr int AQ = AT / 32;    // mt_anyhit: triangles a lane holds

// The test, operand by operand as the plain version computes it.
__device__ __forceinline__ bool mt_test(float ax, float ay, float az, float e0x, float e0y,
                                        float e0z, float e1x, float e1y, float e1z,
                                        float px, float py, float pz,
                                        float dx, float dy, float dz,
                                        float& t, float& u, float& v) {
  const float pvx = dy * e1z - dz * e1y;
  const float pvy = dz * e1x - dx * e1z;
  const float pvz = dx * e1y - dy * e1x;
  const float det = e0x * pvx + e0y * pvy + e0z * pvz;
  const bool near0 = fabsf(det) < DET_EPS;
  const float ood = 1.0f / (near0 ? 1.0f : det);
  const float tx = px - ax;
  const float ty = py - ay;
  const float tz = pz - az;
  u = (tx * pvx + ty * pvy + tz * pvz) * ood;
  const float qvx = ty * e0z - tz * e0y;
  const float qvy = tz * e0x - tx * e0z;
  const float qvz = tx * e0y - ty * e0x;
  v = (dx * qvx + dy * qvy + dz * qvz) * ood;
  t = (e1x * qvx + e1y * qvy + e1z * qvz) * ood;
  return !near0 && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
         t >= 0.0f;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start the copy of columns [col0, col0 + W) of all ten rows into dst,
// 16 bytes a copy, and close the thread's group of copies.
template <int W>
__device__ __forceinline__ void stage_tile(float (*dst)[W], const float* __restrict__ table,
                                           int tp, int col0) {
  constexpr int PER_ROW = W / 4;
  for (int k = threadIdx.x; k < ROWS * PER_ROW; k += blockDim.x) {
    const int r = k / PER_ROW;
    const int c = (k % PER_ROW) * 4;
    cp_async16(&dst[r][c], table + static_cast<size_t>(r) * tp + col0 + c);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ float lane_of(const float4& x, int q) {
  return q == 0 ? x.x : (q == 1 ? x.y : (q == 2 ? x.z : x.w));
}

// ---------------------------------------------------------------------------
// mt_closest
// ---------------------------------------------------------------------------

// Block (x, y): rays [x * CB * CR, ...), thread i taking rays i, i + CB,
// ...; column tiles [y * tiles_per_split, ...) of the first `tiles`.
// Writes one key a ray.
__global__ void __launch_bounds__(CB, 16 * 32 / CB)
mt_closest_kernel(const float* __restrict__ table, int tp, int tiles,
                  const float* __restrict__ p, const float* __restrict__ d, int n,
                  int tiles_per_split, unsigned long long* __restrict__ keys) {
  __shared__ __align__(16) float s[ROWS][CT];
  const int first = blockIdx.y * tiles_per_split;
  const int last = min(tiles, first + tiles_per_split);
  stage_tile<CT>(s, table, tp, first * CT);

  float px[CR], py[CR], pz[CR], dx[CR], dy[CR], dz[CR], bt[CR];
  int bc[CR];
#pragma unroll
  for (int k = 0; k < CR; ++k) {
    const int i = blockIdx.x * (CB * CR) + k * CB + threadIdx.x;
    const bool live = i < n;
    px[k] = live ? p[3 * i] : 0.f;
    py[k] = live ? p[3 * i + 1] : 0.f;
    pz[k] = live ? p[3 * i + 2] : 0.f;
    dx[k] = live ? d[3 * i] : 1.f;
    dy[k] = live ? d[3 * i + 1] : 1.f;
    dz[k] = live ? d[3 * i + 2] : 1.f;
    bt[k] = T_MAX;
    bc[k] = -1;
  }

  for (int tile = first; tile < last; ++tile) {
    cp_async_wait_all();
    __syncthreads();  // every thread's copies of this tile have landed
#pragma unroll 1
    for (int j = 0; j < CT; j += 4) {
      const float4 ax = *reinterpret_cast<const float4*>(&s[0][j]);
      const float4 ay = *reinterpret_cast<const float4*>(&s[1][j]);
      const float4 az = *reinterpret_cast<const float4*>(&s[2][j]);
      const float4 e0x = *reinterpret_cast<const float4*>(&s[3][j]);
      const float4 e0y = *reinterpret_cast<const float4*>(&s[4][j]);
      const float4 e0z = *reinterpret_cast<const float4*>(&s[5][j]);
      const float4 e1x = *reinterpret_cast<const float4*>(&s[6][j]);
      const float4 e1y = *reinterpret_cast<const float4*>(&s[7][j]);
      const float4 e1z = *reinterpret_cast<const float4*>(&s[8][j]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int k = 0; k < CR; ++k) {
          float t, u, v;
          if (mt_test(lane_of(ax, q), lane_of(ay, q), lane_of(az, q), lane_of(e0x, q),
                      lane_of(e0y, q), lane_of(e0z, q), lane_of(e1x, q), lane_of(e1y, q),
                      lane_of(e1z, q), px[k], py[k], pz[k], dx[k], dy[k], dz[k], t, u, v) &&
              t < bt[k] && __float_as_int(s[9][j + q]) >= 0) {
            bt[k] = t + 0.0f;  // -0.0 -> +0.0
            bc[k] = tile * CT + j + q;
          }
        }
      }
    }
    __syncthreads();  // the tile is read: the next may be staged over it
    if (tile + 1 < last) stage_tile<CT>(s, table, tp, (tile + 1) * CT);
  }

#pragma unroll
  for (int k = 0; k < CR; ++k) {
    const int i = blockIdx.x * (CB * CR) + k * CB + threadIdx.x;
    if (i >= n) continue;
    const unsigned long long key =
        bc[k] < 0 ? NO_HIT
                  : (static_cast<unsigned long long>(__float_as_uint(bt[k])) << 32) |
                        static_cast<unsigned>(bc[k]);
    if (gridDim.y == 1) {
      keys[i] = key;
    } else if (bc[k] >= 0) {
      atomicMin(keys + i, key);
    }
  }
}

// One thread a ray: the key's column and t, u and v recomputed there.
__global__ void __launch_bounds__(FINISH)
mt_closest_finish_kernel(const float* __restrict__ table, int tp, const float* __restrict__ p,
                         const float* __restrict__ d, int n,
                         const unsigned long long* __restrict__ keys,
                         float* __restrict__ t_out, int* __restrict__ tri_out,
                         float* __restrict__ u_out, float* __restrict__ v_out) {
  const int i = blockIdx.x * FINISH + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = keys[i];
  if (key == NO_HIT) {
    t_out[i] = T_MAX;
    tri_out[i] = -1;
    u_out[i] = 0.f;
    v_out[i] = 0.f;
    return;
  }
  const float* col = table + static_cast<unsigned>(key & 0xFFFFFFFFull);
  float t, u, v;
  mt_test(col[0], col[tp], col[2 * tp], col[3 * tp], col[4 * tp], col[5 * tp], col[6 * tp],
          col[7 * tp], col[8 * tp], p[3 * i], p[3 * i + 1], p[3 * i + 2], d[3 * i],
          d[3 * i + 1], d[3 * i + 2], t, u, v);
  t_out[i] = __int_as_float(static_cast<int>(key >> 32));
  tri_out[i] = __float_as_int(col[9 * tp]);
  u_out[i] = u;
  v_out[i] = v;
}

// ---------------------------------------------------------------------------
// mt_anyhit
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(AW * 32, 16 / AW)
mt_anyhit_kernel(const float* __restrict__ table, int tp, int ntiles,
                 const float* __restrict__ p, const float* __restrict__ d,
                 const float* __restrict__ tmax, int n, int* __restrict__ occ_out) {
  __shared__ __align__(16) float s[ROWS][AT];
  __shared__ float4 ray[AR][2];   // p xyz, tmax | d xyz, 0
  __shared__ int list[2][AR];     // the live rays, compacted
  __shared__ int occ[AR];
  __shared__ int count;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  stage_tile<AT>(s, table, tp, 0);

  for (int r = threadIdx.x; r < AR; r += AW * 32) {
    const int i = blockIdx.x * AR + r;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;  // past n: tmax 0, never live
    if (i < n) {
      a = make_float4(p[3 * i], p[3 * i + 1], p[3 * i + 2], tmax[i]);
      b = make_float4(d[3 * i], d[3 * i + 1], d[3 * i + 2], 0.f);
    }
    ray[r][0] = a;
    ray[r][1] = b;
    occ[r] = 0;
  }
  __syncthreads();
  if (warp == 0) {  // the first list: every ray with tmax > 0 (NaN is not)
    int c = 0;
    for (int r = lane; r < AR; r += 32) {
      const bool live = ray[r][0].w > 0.f;
      const unsigned m = __ballot_sync(FULL, live);
      if (live) list[0][c + __popc(m & ((1u << lane) - 1u))] = r;
      c += __popc(m);
    }
    if (lane == 0) count = c;
  }

  int cur = 0;
  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait_all();
    __syncthreads();  // the tile, the list and its count are in place
    const int live = count;
    if (live == 0) break;
    if (warp < live) {
      float tri[9][AQ];
      unsigned ids_ok = 0;
#pragma unroll
      for (int q = 0; q < AQ; ++q) {
#pragma unroll
        for (int r = 0; r < 9; ++r) tri[r][q] = s[r][q * 32 + lane];
        ids_ok |= (__float_as_int(s[9][q * 32 + lane]) >= 0 ? 1u : 0u) << q;
      }
      for (int e = warp; e < live; e += AW) {
        const int r = list[cur][e];
        const float4 a = ray[r][0];
        const float4 dd = ray[r][1];
        bool hit = false;
#pragma unroll
        for (int q = 0; q < AQ; ++q) {
          float t, u, v;
          hit |= mt_test(tri[0][q], tri[1][q], tri[2][q], tri[3][q], tri[4][q], tri[5][q],
                         tri[6][q], tri[7][q], tri[8][q], a.x, a.y, a.z, dd.x, dd.y, dd.z,
                         t, u, v) &&
                 t < a.w && ((ids_ok >> q) & 1u);
        }
        if (__any_sync(FULL, hit) && lane == 0) occ[r] = 1;
      }
    }
    __syncthreads();  // every listed ray has met the tile
    if (tile + 1 < ntiles) stage_tile<AT>(s, table, tp, (tile + 1) * AT);
    if (warp == 0) {  // the next list: this one less the rays just occluded
      int c = 0;
      for (int e0 = 0; e0 < live; e0 += 32) {
        const int e = e0 + lane;
        const int r = e < live ? list[cur][e] : 0;
        const bool keep = e < live && !occ[r];
        const unsigned m = __ballot_sync(FULL, keep);
        if (keep) list[cur ^ 1][c + __popc(m & ((1u << lane) - 1u))] = r;
        c += __popc(m);
      }
      if (lane == 0) count = c;
    }
    cur ^= 1;
  }

  for (int r = threadIdx.x; r < AR; r += AW * 32) {
    const int i = blockIdx.x * AR + r;
    if (i < n) occ_out[i] = occ[r];
  }
}

}  // namespace

// Plain C entry points for ctypes. Each launches on the given stream and
// returns the CUDA error code (0 = launched). n must be > 0, and
// 0 <= cols <= tp: the kernels walk the tiles that reach into the first
// cols columns, at least one.

// Blocks of mt_closest_kernel resident on one SM (the launch plan's input).
extern "C" int mt_closest_blocks_per_sm(int* blocks) {
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, mt_closest_kernel, CB, 0));
}

// splits x tiles_per_split covers the tiles of the first cols columns;
// keys is (n,) 64-bit scratch, cleared here when splits > 1.
extern "C" int mt_closest_launch(const float* table, int tp, int cols, const float* p,
                                 const float* d, int n, int splits, int tiles_per_split,
                                 unsigned long long* keys, float* t_out, int* tri_out,
                                 float* u_out, float* v_out, void* stream) {
  const int tiles = max(1, (cols + CT - 1) / CT);
  if (tp % CT || cols < 0 || cols > tp || splits < 1 || tiles_per_split < 1 ||
      (splits - 1) * tiles_per_split >= tiles || splits * tiles_per_split < tiles) {
    return static_cast<int>(cudaErrorInvalidValue);  // an empty or a missing split
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits > 1) {
    const cudaError_t e = cudaMemsetAsync(keys, 0xFF, static_cast<size_t>(n) * 8, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((n + CB * CR - 1) / (CB * CR), splits);
  mt_closest_kernel<<<grid, CB, 0, s>>>(table, tp, tiles, p, d, n, tiles_per_split, keys);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  mt_closest_finish_kernel<<<(n + FINISH - 1) / FINISH, FINISH, 0, s>>>(
      table, tp, p, d, n, keys, t_out, tri_out, u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mt_anyhit_launch(const float* table, int tp, int cols, const float* p,
                                const float* d, const float* tmax, int n,
                                int* occ_out, void* stream) {
  if (tp % AT || cols < 0 || cols > tp) return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = max(1, (cols + AT - 1) / AT);
  mt_anyhit_kernel<<<(n + AR - 1) / AR, AW * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      table, tp, ntiles, p, d, tmax, n, occ_out);
  return static_cast<int>(cudaGetLastError());
}
