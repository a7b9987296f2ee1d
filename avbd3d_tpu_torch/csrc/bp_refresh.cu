// The broadphase refresh on the card: the candidate lists (k_bp_tables, then
// k_bp_lists) and the grid step's refresh predicate (k_refresh_needed).
//
// Neither replaces a Pallas kernel: the reference computes both in XLA
// (avbd3d_tpu/ops/broadphase.py:231-387 candidate_lists, :153-188 the reuse
// bounds of refresh_or_reuse).  Their plain versions are the port's torch
// code, ops/broadphase.candidate_lists_plain and refresh_needed_plain, which
// took ~216 and ~96 launches of small torch operations a call at N = 5120.
//
// candidate_lists.  For each row body i and every column body j: the
// Chebyshev world-AABB gap minus the margin, the mask (gap <= 0, a real
// pair, j != i, row i dynamic, j not one of row i's exclusions), the unique
// int32 key int(clamp((gap + range) * scale, 0, q_max)) * N + j, the D
// smallest masked keys ascending (their partners key % N), the threshold (the
// D-th key, or INT32_MAX when the row has fewer), the directed candidate
// count and the slack (the least positive gap of a dynamic row to a static
// real column).  Every float expression repeats the plain version's
// statement order and the library is built with --fmad=false, so keys,
// slots, thresholds and counts are identical to it and the slack, a min, is
// bit for bit.
//
// What bounds it on the H100: operations.  The pair test is ~15 float
// operations on each of N^2 pairs (3.9e8 at N = 5120, ~6 us at 67 TFLOP/s);
// the bytes are the 32-byte column table, read once from device memory and
// once a block from L2.  Design:
//
// 1. k_bp_tables, a thread a body: the world-AABB halves (world_halves,
//    the plain version's operations), written with the centre, radius and
//    dynamic flag as one 32-byte table row (two float4), and the largest
//    half extent folded by the last block to finish (a ticket), which fixes
//    the keys' range and scale.
// 2. k_bp_lists, a block of 8 warps takes 2 to 32 consecutive rows (a
//    warp owns 1, 2 or 4 of them, or each of 2 or 4 rows has its columns
//    split over 4 or 2 warps; the launcher picks the most rows that still
//    give the SMs 1.5 blocks each).  The column table streams through shared
//    memory in tiles of BPL_TILE bodies (cp.async, one tile ahead), and
//    every row of the block tests each staged column: L2 reads fall by the
//    rows a block.  Each tile's chunks of 32 columns are folded into bounds
//    (the axes' extents, the radii), and a row passes over a chunk none of
//    whose columns can be listed or lower its slack (chunk_passes: exact,
//    with a margin for the float gap's rounding), so a spatially ordered
//    world tests a few chunks a row.  A warp's lane takes a column; a row's
//    masked keys go by ballot into the row's buffer of BPL_CAP keys in
//    shared memory, at the count before them.  A full buffer is cut to its
//    D smallest keys (bp_cut: each key written at its rank), which is
//    exact: the keys are unique, and a key outside the D smallest of a
//    subset is outside the D smallest of the row.  At the end the buffer is
//    cut once more, which leaves the selection ascending (a split row's
//    parts are then merged by rank); then the slots, the partners key % N
//    and the threshold.  Shared memory does not grow with N.  Rows of
//    static bodies (the ground, padding) select nothing, and a block of
//    them skips the columns.  Each block writes its count, kept slots and
//    slack; the last block to finish folds them in index order (integer
//    sums and a min: exact in any order) into cand, kept, dropped = cand -
//    kept and slack.
//
// The row table and the column table are separate operands (rows with their
// global offset row0): a body-sharded world passes its all-gathered columns
// and reduces the scalars across shards itself.  A batch of B worlds is one
// launch with grid.y = B, each world on its own slices.
//
// k_refresh_needed (the grid step's predicate, one launch): the two reuse
// bounds through K2's anchor-deviation fold (avbd_common.cuh: anchor_terms,
// fold_group over groups of LANES_WARPS bodies, fold_parts_warp,
// dev_mm_block), so its deviations are the bits of K2's lanes 3 and 4 on the
// same state, then dev_mm > 0.5 * margin or dev_raw > slack + margin in
// float32.  No float atomics anywhere; the tickets are 0 before and after
// every launch.
#include "avbd_common.cuh"

#define BPT_THREADS 256
#define BPL_THREADS 256
#define BPL_WARPS (BPL_THREADS / 32)
#define BP_MAX_DEGREE 64
#define BPL_CAP (2 * BP_MAX_DEGREE)  // a row's selection buffer, keys
#define BPL_TILE 1024                // columns a shared-memory tile (32 chunks of 32)
#define BPL_RPW 4                    // the most slots (rows or parts of rows) a warp takes
#define BPL_MAX_SPLIT 4              // the most slots a row's columns are split over
#define BPL_CHUNKS (BPL_TILE / 32)
static_assert(BPL_CHUNKS == 32 && BPL_TILE % BPL_THREADS == 0 && BPL_THREADS == 8 * BPL_CHUNKS,
              "a lane tests a chunk of a tile, 8 threads fold its bounds");
// Dynamic shared memory of k_bp_lists: two tiles of columns (two float4 a
// column), filled by cp.async.
#define BPL_DYN_SMEM (2 * 2 * BPL_TILE * 16)

// cp.async of 16 bytes into shared memory, and its group fence / wait.
__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
#else
  *dst = *src;
#endif
}
__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}
__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 0;\n" ::);
#endif
}
#define RN_THREADS 256
#define KEY_NONE 0x7fffffff  // INT32_MAX: no key (an unmasked column; no threshold)

// table: per body two float4, (c.x, c.y, c.z, radius) and (wh.x, wh.y, wh.z,
// dynamic 1 / 0); the halves are ext * ext_scale (size * 0.5, or the halves
// themselves times 1), dynamic is dyn_key > 0 (inv_mass, or a 0 / 1 flag).
// part_max: a float a block; ticket: 0 at launch, 0 after; max_wh: the
// largest half extent.  Each per world (blockIdx.y).
__global__ void __launch_bounds__(BPT_THREADS)
k_bp_tables(const float* pos, const float* quat, const float* ext, float ext_scale,
            const float* radius, const float* dyn_key, int n, float4* table, float* part_max,
            unsigned int* ticket, float* max_wh) {
  const size_t w = blockIdx.y;
  pos += w * 3 * n;
  quat += w * 4 * n;
  ext += w * 3 * n;
  radius += w * n;
  dyn_key += w * n;
  table += w * 2 * n;
  part_max += w * gridDim.x;
  ticket += w;
  max_wh += w;
  __shared__ float sh[BPT_THREADS / 32];
  __shared__ bool sh_last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * BPT_THREADS + threadIdx.x;
  float m = -INFINITY;
  if (i < n) {
    V3 c = ld3(pos, i, n);
    V3 h = v3(ext[i] * ext_scale, ext[n + i] * ext_scale, ext[2 * n + i] * ext_scale);
    V3 wh = world_halves(ld4(quat, i, n), h);
    table[2 * i] = make_float4(c.x, c.y, c.z, radius[i]);
    table[2 * i + 1] = make_float4(wh.x, wh.y, wh.z, dyn_key[i] > F(0.0) ? F(1.0) : F(0.0));
    m = fmaxf(fmaxf(wh.x, wh.y), wh.z);
  }
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, off));
  if (lane == 0) sh[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < BPT_THREADS / 32; ++k) m = fmaxf(m, sh[k]);
    RACE_DELAY();
    part_max[blockIdx.x] = m;
    __threadfence();
    RACE_DELAY();
    sh_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!sh_last || warp != 0) return;
  __threadfence();
  float v = -INFINITY;
  for (int b = lane; b < (int)gridDim.x; b += 32) v = fmaxf(v, __ldcg(part_max + b));
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, off));
  if (lane == 0) {
    *max_wh = v;
    *ticket = 0u;
  }
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL_MASK, v, off);
  return v;
}

// A row's selection buffer (cnt unique keys in buf[0 .. cnt)) cut to its
// ``keep`` smallest keys, each written at its rank: buf[0 .. min(cnt, keep))
// ascending.  By the whole warp that owns the row; lane l ranks entries l,
// l + 32, ... against every entry (the keys are unique, so the ranks are
// distinct).  Returns min(cnt, keep).
__device__ __forceinline__ int bp_cut(int* buf, int cnt, int keep, int lane) {
  constexpr int PER = BPL_CAP / 32;
  int v[PER], rk[PER];
#pragma unroll
  for (int s = 0; s < PER; ++s) {
    v[s] = lane + 32 * s < cnt ? buf[lane + 32 * s] : KEY_NONE;
    rk[s] = 0;
  }
  for (int t = 0; t < cnt; ++t) {
    const int x = buf[t];
#pragma unroll
    for (int s = 0; s < PER; ++s) rk[s] += x < v[s];
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < PER; ++s)
    if (lane + 32 * s < cnt && rk[s] < keep) buf[rk[s]] = v[s];
  __syncwarp();
  return cnt < keep ? cnt : keep;
}

// A chunk of 32 columns (within a tile) as the bounds that decide whether a
// row can pass over it: per axis the least c - half and the largest c +
// half (a NaN on an axis in any column makes that axis' bounds NaN, so no
// row uses it), the largest |c| + |half| over axes and columns, the largest
// radius, and the largest radius of a static column (-inf without one).
// Min and max are exact in any order.  By 8 threads a chunk (a thread folds
// columns sub, sub + 8, ... of the 32, then the 8 fold by shuffles);
// ``valid``: the chunk lies inside the tile; thread sub 0 writes the
// CHUNK_FLOATS floats.
#define CHUNK_FLOATS 12
__device__ __forceinline__ void chunk_bounds(const float4* chunk, int sub, bool valid, float* out) {
  float v[9] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY, -INFINITY,
                -INFINITY, -INFINITY, -INFINITY};
  if (valid) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 pc = chunk[2 * (sub + 8 * q)], pw = chunk[2 * (sub + 8 * q) + 1];
      v[0] = min_nan(v[0], pc.x - pw.x);
      v[1] = min_nan(v[1], pc.y - pw.y);
      v[2] = min_nan(v[2], pc.z - pw.z);
      v[3] = max_nan(v[3], pc.x + pw.x);
      v[4] = max_nan(v[4], pc.y + pw.y);
      v[5] = max_nan(v[5], pc.z + pw.z);
      v[6] = fmaxf(v[6], fmaxf(fmaxf(fabsf(pc.x) + fabsf(pw.x), fabsf(pc.y) + fabsf(pw.y)),
                               fabsf(pc.z) + fabsf(pw.z)));
      v[7] = fmaxf(v[7], pc.w);
      v[8] = fmaxf(v[8], pw.w == F(0.0) ? pc.w : -INFINITY);
    }
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const float o = __shfl_xor_sync(FULL_MASK, v[k], off, 8);
      v[k] = k < 3 ? min_nan(v[k], o) : (k < 6 ? max_nan(v[k], o) : fmaxf(v[k], o));
    }
  }
  if (valid && sub == 0)
#pragma unroll
    for (int k = 0; k < 9; ++k) out[k] = v[k];
}

// Whether a dynamic row (centre rc, halves rw, mag: its largest |c| + |half|)
// can pass over a chunk (chunk_bounds) without changing its list, count or
// slack: no column of the chunk can be a real pair (the float test
// rc.w + pc.w + margin > margin rises with pc.w, so the chunk's largest
// radius decides it), or every column's gap is above 0 and no static column
// can be real (the slack's candidates).  The gap: on each axis whose
// bounds are numbers, |rc - pc| - (rw + pw) >= max((rc - rw) - hi,
// lo - (rc + rw)) for every column, so the Chebyshev gap less the margin is
// at least their largest less the margin (a column with a NaN term has a
// NaN gap and counts nowhere); the kernel's float gap differs
// from the exact one by under 4 ulps of mag + chunk mag + |margin| (each of
// its roundings is one), and so does the bound, so a bound above 32 ulps of
// that scale leaves every column's float gap above 0.
__device__ __forceinline__ bool chunk_passes(float4 rc, float4 rw, float mag, const float* ch,
                                             float margin) {
  if (!(rc.w + ch[7] + margin > margin)) return true;
  if (rc.w + ch[8] + margin > margin) return false;
  float lb = -INFINITY;
  lb = fmaxf(lb, fmaxf((rc.x - rw.x) - ch[3], ch[0] - (rc.x + rw.x)));
  lb = fmaxf(lb, fmaxf((rc.y - rw.y) - ch[4], ch[1] - (rc.y + rw.y)));
  lb = fmaxf(lb, fmaxf((rc.z - rw.z) - ch[5], ch[2] - (rc.z + rw.z)));
  return lb - margin > F(32.0) * F(5.9604645e-08) * (mag + ch[6] + fabsf(margin));
}

// rows: n_rows table rows (global ids row0 ..), cols: n table rows (every
// body); excl: (n_excl, n_rows) partners each row must not list (-1 none).
// nb, key: (degree, n_rows); thr: (n_rows); part_cnt: (cand, kept) a block;
// part_slack: a float a block; ticket: 0 at launch, 0 after; out_i: cand,
// kept, dropped; out_slack: the slack.  R rows a block (2 .. 32): the block
// has BPL_WARPS * rpw slots (rpw = max(R / BPL_WARPS, 1)), slot u = warp +
// BPL_WARPS * q of warp ``warp``, and slot u takes row u % R and the chunks
// c with c % S == u / R (S = BPL_WARPS * rpw / R splits of each row's
// columns); the S slots of a row are merged at the end.  Each per world
// (blockIdx.y).
__global__ void __launch_bounds__(BPL_THREADS)
k_bp_lists(const float4* rows, const float4* cols, const float* max_wh, const int* excl,
           int n_excl, int n_rows, int n, int row0, int degree, int q_max, float margin, int R,
           int* nb, int* key, int* thr, int* part_cnt, float* part_slack, unsigned int* ticket,
           int* out_i, float* out_slack) {
  constexpr int RPW = BPL_RPW;
  const int rpw = R < BPL_WARPS ? 1 : R / BPL_WARPS;
  const int S = BPL_WARPS * rpw / R;
  extern __shared__ float4 sh_dyn[];  // two tiles: 2 * BPL_TILE columns
  __shared__ float sh_chunk[BPL_CHUNKS][CHUNK_FLOATS];
  __shared__ int sh_buf[BPL_WARPS * RPW][BPL_CAP];
  __shared__ int sh_cand[BPL_WARPS * RPW], sh_nsel[BPL_WARPS * RPW];
  __shared__ float sh_slack[BPL_WARPS * RPW];
  __shared__ int sh_red[2][BPL_WARPS];
  __shared__ float sh_redf[BPL_WARPS];
  __shared__ bool sh_last;
  const size_t w = blockIdx.y;
  rows += w * 2 * n_rows;
  cols += w * 2 * n;
  max_wh += w;
  excl += w * n_excl * n_rows;
  nb += w * degree * n_rows;
  key += w * degree * n_rows;
  thr += w * n_rows;
  part_cnt += w * 2 * gridDim.x;
  part_slack += w * gridDim.x;
  ticket += w;
  out_i += w * 3;
  out_slack += w;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int r_base = blockIdx.x * R;
  // This warp's slots r: slot r * BPL_WARPS + warp, its row and split.
  float4 rc[RPW], rw[RPW];
  bool dyn[RPW];
  int cnt[RPW], cand[RPW], row_of[RPW], split_of[RPW];
  float smin[RPW];
  bool any_dyn = false;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int u = (r < rpw ? r : 0) * BPL_WARPS + warp;
    row_of[r] = u % R;
    split_of[r] = u / R;
    const int i = r_base + row_of[r];
    rc[r] = rows[2 * i];
    rw[r] = rows[2 * i + 1];
    dyn[r] = r < rpw && rw[r].w > F(0.0);
    any_dyn |= dyn[r];
    cnt[r] = 0;
    cand[r] = 0;
    smin[r] = F(1.0e9);
  }
  // Rows of static bodies select nothing; a block of them skips the columns.
  if (__syncthreads_or(any_dyn)) {
    // _key_packing: the range and the scale, a float32 division.
    const float gap_range = fmaxf(F(2.0) * *max_wh + margin, F(1e-6));
    const float qmax_f = (float)q_max;
    const float scale = qmax_f / gap_range;
    // The column table in tiles of BPL_TILE bodies through shared memory,
    // copied by cp.async one tile ahead of the tests.  Block b starts at
    // tile b % n_tiles (the blocks' reads spread over L2; the results do not
    // depend on the order).  After a tile lands the block folds each chunk
    // of 32 columns into its bounds (chunk_bounds, 8 threads a chunk), which
    // let a row pass over a chunk none of whose columns can count
    // (chunk_passes).
    const int n_tiles = (n + BPL_TILE - 1) / BPL_TILE;
    const int start = blockIdx.x % n_tiles;
    auto issue = [&](int it) {
      const int t = (start + it) % n_tiles;
      float4* dst = sh_dyn + (it & 1) * 2 * BPL_TILE;
#pragma unroll
      for (int q = 0; q < BPL_TILE / BPL_THREADS; ++q) {
        const int jl = q * BPL_THREADS + threadIdx.x, j = t * BPL_TILE + jl;
        if (j < n) {
          cp_async16(dst + 2 * jl, cols + 2 * j);
          cp_async16(dst + 2 * jl + 1, cols + 2 * j + 1);
        }
      }
      cp_async_commit();
    };
    // A row's largest |c| + |half| over the axes (the rounding bound's scale).
    float mag_r[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
      mag_r[r] = fmaxf(fmaxf(fabsf(rc[r].x) + fabsf(rw[r].x), fabsf(rc[r].y) + fabsf(rw[r].y)),
                       fabsf(rc[r].z) + fabsf(rw[r].z));
    issue(0);
    for (int it = 0; it < n_tiles; ++it) {
      cp_async_wait_all();
      __syncthreads();  // the tile has landed; every warp is done with the other buffer
      if (it + 1 < n_tiles) issue(it + 1);
      const float4* tile = sh_dyn + (it & 1) * 2 * BPL_TILE;
      const int t0 = ((start + it) % n_tiles) * BPL_TILE;
      const int tile_cols = n - t0 < BPL_TILE ? n - t0 : BPL_TILE;  // a multiple of 32
      {
        const int c = threadIdx.x >> 3;  // 8 threads a chunk
        chunk_bounds(tile + 2 * 32 * c, threadIdx.x & 7, c < tile_cols / 32, &sh_chunk[c][0]);
      }
      __syncthreads();
      // The chunks each row tests: lane c tests chunk c of the tile.
      unsigned need[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        bool nd = false;
        if (dyn[r] && lane < tile_cols / 32 && lane % S == split_of[r])
          nd = !chunk_passes(rc[r], rw[r], mag_r[r], &sh_chunk[lane][0], margin);
        need[r] = __ballot_sync(FULL_MASK, nd);
      }
      unsigned any = 0;
#pragma unroll
      for (int r = 0; r < RPW; ++r) any |= need[r];
      while (any) {  // warp-uniform
        const int c = (__ffs(any) - 1) * 32;
        any &= any - 1;
        const int j = t0 + c + lane;
        const float4 pc = tile[2 * (c + lane)], pw = tile[2 * (c + lane) + 1];
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          if (!((need[r] >> (c / 32)) & 1u)) continue;  // warp-uniform
          const int i = r_base + row_of[r];
          // _cheb_gap (torch.amax: a NaN term makes the gap NaN), _real_pair,
          // the mask and _keys in the plain version's order.
          const float gap = max_nan(max_nan(fabsf(rc[r].x - pc.x) - (rw[r].x + pw.x),
                                            fabsf(rc[r].y - pc.y) - (rw[r].y + pw.y)),
                                    fabsf(rc[r].z - pc.z) - (rw[r].z + pw.z)) - margin;
          bool m = false;
          int k = KEY_NONE;
          if (gap <= F(0.0)) {
            m = rc[r].w + pc.w + margin > margin && j != row0 + i;
            for (int e = 0; e < n_excl && m; ++e) m = j != __ldg(excl + (size_t)e * n_rows + i);
            if (m) k = (int)clipf((gap + gap_range) * scale, F(0.0), qmax_f) * n + j;
          } else if (gap > F(0.0) && pw.w == F(0.0) && rc[r].w + pc.w + margin > margin &&
                     j != row0 + i) {
            smin[r] = fminf(smin[r], gap);
          }
          const unsigned bal = __ballot_sync(FULL_MASK, m);
          if (bal) {  // warp-uniform
            int* buf = sh_buf[r * BPL_WARPS + warp];
            const int h = __popc(bal);
            // A full buffer keeps its D smallest keys: a key outside the D
            // smallest of a subset is outside the D smallest of the row.
            if (cnt[r] + h > BPL_CAP) cnt[r] = bp_cut(buf, cnt[r], degree, lane);
            if (m) buf[cnt[r] + __popc(bal & below)] = k;
            cnt[r] += h;
            cand[r] += h;
            __syncwarp();
          }
        }
      }
    }
  }
  // Each slot's selection in ascending order (its D smallest keys, or all),
  // its count and slack.
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    if (r >= rpw) break;
    const int u = r * BPL_WARPS + warp;
    const int nsel = dyn[r] ? bp_cut(sh_buf[u], cnt[r], degree, lane) : 0;
    float sm = smin[r];
    for (int off = 16; off > 0; off >>= 1) sm = fminf(sm, __shfl_xor_sync(FULL_MASK, sm, off));
    if (lane == 0) {
      sh_nsel[u] = nsel;
      sh_cand[u] = cand[r];
      sh_slack[u] = sm;
    }
  }
  __syncthreads();
  // A row split over S slots: its D smallest keys are the D smallest of its
  // slots' (each slot's D smallest of its columns), ranked by a binary search
  // in each slot's ascending list and written at their rank into the row's
  // first slot; its count sums and its slack takes the min.  Warp lr merges
  // row lr.
  if (S > 1) {
    if (warp < R) {
      const int lr = warp;
      int pre[BPL_MAX_SPLIT + 1];
      pre[0] = 0;
      int c_row = 0;
      float s_row = F(1.0e9);
#pragma unroll
      for (int sp = 0; sp < BPL_MAX_SPLIT; ++sp) {
        const bool in = sp < S;
        pre[sp + 1] = pre[sp] + (in ? sh_nsel[lr + R * sp] : 0);
        c_row += in ? sh_cand[lr + R * sp] : 0;
        s_row = in ? fminf(s_row, sh_slack[lr + R * sp]) : s_row;
      }
      const int tot = pre[BPL_MAX_SPLIT];
      constexpr int PER = BPL_MAX_SPLIT * BP_MAX_DEGREE / 32;
      int v[PER], rk[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int p = lane + 32 * k;
        v[k] = KEY_NONE;
        rk[k] = 0;
        if (p < tot) {
#pragma unroll
          for (int sp = 0; sp < BPL_MAX_SPLIT; ++sp)
            if (p >= pre[sp] && p < pre[sp + 1]) v[k] = sh_buf[lr + R * sp][p - pre[sp]];
#pragma unroll
          for (int sp = 0; sp < BPL_MAX_SPLIT; ++sp) {
            if (sp >= S) break;
            const int* list = sh_buf[lr + R * sp];
            int lo = 0, hi = pre[sp + 1] - pre[sp];
            while (lo < hi) {
              const int mid = (lo + hi) >> 1;
              if (list[mid] < v[k]) lo = mid + 1;
              else hi = mid;
            }
            rk[k] += lo;
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < PER; ++k)
        if (lane + 32 * k < tot && rk[k] < degree) sh_buf[lr][rk[k]] = v[k];
      __syncwarp();
      if (lane == 0) {
        sh_nsel[lr] = tot < degree ? tot : degree;
        sh_cand[lr] = c_row;
        sh_slack[lr] = s_row;
      }
    }
    __syncthreads();
  }
  // Slot d of row i: the selected key of rank d; -1 / 0 past the selection
  // (a thread a (slot, row), the block's rows consecutive).  The threshold:
  // the D-th key, or none.
  for (int t = threadIdx.x; t < degree * R; t += BPL_THREADS) {
    const int d = t / R, lr = t - d * R, i = r_base + lr;
    const bool sel = d < sh_nsel[lr];
    const int k = sel ? sh_buf[lr][d] : 0;
    nb[(size_t)d * n_rows + i] = sel ? k % n : -1;
    key[(size_t)d * n_rows + i] = k;
  }
  if (threadIdx.x < R) {
    const int lr = threadIdx.x;
    thr[r_base + lr] = sh_nsel[lr] == degree ? sh_buf[lr][degree - 1] : KEY_NONE;
  }
  if (threadIdx.x == 0) {
    int c_blk = 0, k_blk = 0;
    float s_blk = F(1.0e9);
    for (int lr = 0; lr < R; ++lr) {
      c_blk += sh_cand[lr];
      k_blk += sh_nsel[lr];
      s_blk = fminf(s_blk, sh_slack[lr]);
    }
    RACE_DELAY();
    part_cnt[2 * blockIdx.x] = c_blk;
    part_cnt[2 * blockIdx.x + 1] = k_blk;
    part_slack[blockIdx.x] = s_blk;
    __threadfence();
    RACE_DELAY();
    sh_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!sh_last) return;
  // The last block: every block's partials are visible (each fenced before
  // its ticket); read them from L2, past this SM's L1.
  __threadfence();
  int c_sum = 0, k_sum = 0;
  float s_min = F(1.0e9);
  for (int b = threadIdx.x; b < (int)gridDim.x; b += BPL_THREADS) {
    c_sum += __ldcg(part_cnt + 2 * b);
    k_sum += __ldcg(part_cnt + 2 * b + 1);
    s_min = fminf(s_min, __ldcg(part_slack + b));
  }
  c_sum = warp_sum(c_sum);
  k_sum = warp_sum(k_sum);
  for (int off = 16; off > 0; off >>= 1)
    s_min = fminf(s_min, __shfl_xor_sync(FULL_MASK, s_min, off));
  if (lane == 0) {
    sh_red[0][warp] = c_sum;
    sh_red[1][warp] = k_sum;
    sh_redf[warp] = s_min;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < BPL_WARPS; ++k) {
      c_sum += sh_red[0][k];
      k_sum += sh_red[1][k];
      s_min = fminf(s_min, sh_redf[k]);
    }
    out_i[0] = c_sum;
    out_i[1] = k_sum;
    out_i[2] = c_sum - k_sum;
    *out_slack = s_min;
    *ticket = 0u;
  }
}

// The refresh predicate on one world: part: LANE_PARTS floats a group of
// LANES_WARPS bodies (3-7 used); dv: per body (disp, chord or -1); ticket: 0
// at launch, 0 after; dev_out: dev_mm, dev_raw; need_out: the () bool.
__global__ void __launch_bounds__(RN_THREADS)
k_refresh_needed(const float* pos, const float* quat, const float* radius, const float* inv_mass,
                 const float* anchor, const float* anchor_q, const float* slack, int n,
                 float half_margin, float margin, float* part, float4* dv, unsigned int* ticket,
                 float* dev_out, unsigned char* need_out) {
  __shared__ float sh[LANE_PARTS][RN_THREADS];
  __shared__ float sh_fold[LANE_PARTS];
  __shared__ float sh_dev[RN_THREADS / 32];
  __shared__ bool sh_last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * RN_THREADS + threadIdx.x;
  if (i < n) {
    AnchorTerms a = anchor_terms(ld3(pos, i, n), ld4(quat, i, n), ld3(anchor, i, n),
                                 ld4(anchor_q, i, n), radius[i], inv_mass[i] > F(0.0));
    float mf = a.moved ? F(1.0) : F(0.0);
    RACE_DELAY();
    dv[i] = make_float4(a.disp.x, a.disp.y, a.disp.z, a.moved ? a.chord : F(-1.0));
    __threadfence();
    sh[3][threadIdx.x] = a.moved ? sqrtf(a.disp2) + a.chord : F(0.0);
    sh[4][threadIdx.x] = mf;
    sh[5][threadIdx.x] = a.disp.x * mf;
    sh[6][threadIdx.x] = a.disp.y * mf;
    sh[7][threadIdx.x] = a.disp.z * mf;
  } else {
    for (int k = 3; k < LANE_PARTS; ++k) sh[k][threadIdx.x] = F(0.0);
  }
  __syncthreads();
  // One thread a (group, partial), the group's bodies in order.
  const int groups = RN_THREADS / LANES_WARPS;
  if (threadIdx.x < groups * 5) {
    const int g = threadIdx.x / 5, k = 3 + threadIdx.x % 5;
    const int gg = blockIdx.x * groups + g;
    if (gg * LANES_WARPS < n) {
      float v = fold_group(&sh[k][g * LANES_WARPS], part_op(k));
      RACE_DELAY();
      part[gg * LANE_PARTS + k] = v;
      __threadfence();
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    RACE_DELAY();
    sh_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!sh_last) return;
  __threadfence();
  const int n_groups = (n + LANES_WARPS - 1) / LANES_WARPS;
  if (warp >= 3 && warp < LANE_PARTS) {
    float v = fold_parts_warp(part, n_groups, warp, lane);
    if (lane == 0) sh_fold[warp] = v;
  }
  __syncthreads();
  float nmc = fmaxf(sh_fold[4], F(1.0));
  V3 t = v3(sh_fold[5] / nmc, sh_fold[6] / nmc, sh_fold[7] / nmc);
  float dev_mm = dev_mm_block(dv, n, t, sh_dev);
  if (threadIdx.x == 0) {
    const float dev_raw = sh_fold[3];
    dev_out[0] = dev_mm;
    dev_out[1] = dev_raw;
    *need_out = (dev_mm > half_margin) || (dev_raw > *slack + margin) ? 1 : 0;
    *ticket = 0u;
  }
}

extern "C" {

// ptrs: pos, quat, ext, radius, dyn_key, then table (2 n float4), max_wh (1
// float), then scratch: part_max (a float a block) and the ticket; each per
// world of ``batch``.  Returns the CUDA error code of the launch.
int avbd_bp_tables(void** ptrs, int n, int batch, float ext_scale, void* stream) {
  const int blocks = (n + BPT_THREADS - 1) / BPT_THREADS;
  k_bp_tables<<<dim3(blocks, batch), BPT_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)ptrs[0], (const float*)ptrs[1], (const float*)ptrs[2], ext_scale,
      (const float*)ptrs[3], (const float*)ptrs[4], n, (float4*)ptrs[5], (float*)ptrs[7],
      (unsigned int*)ptrs[8], (float*)ptrs[6]);
  return (int)cudaGetLastError();
}

// ptrs: rows, cols, max_wh, excl, then nb, key, thr, out_i (cand, kept,
// dropped), out_slack, then scratch: part_cnt (2 ints a block), part_slack
// (a float a block) and the ticket; each per world of ``batch``.  The
// blocks take rows_per_block rows each (2, 4, 8, 16 or 32; n_rows a
// multiple of it); the shared memory is fixed (64 KB of column tiles and
// ~18 KB of buffers a block, whatever N).
int avbd_bp_lists(void** ptrs, int n_rows, int n, int row0, int degree, int n_excl, int q_max,
                  float margin, int batch, int rows_per_block, void* stream) {
  if (degree < 1 || degree > BP_MAX_DEGREE || n % 32 || rows_per_block < 1 ||
      n_rows % rows_per_block)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_rows / rows_per_block, batch);
  const int R = rows_per_block;
  if (R < BPL_WARPS / BPL_MAX_SPLIT || R > BPL_WARPS * BPL_RPW || (R & (R - 1)))
    return (int)cudaErrorInvalidValue;
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(k_bp_lists, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         BPL_DYN_SMEM);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  k_bp_lists<<<grid, BPL_THREADS, BPL_DYN_SMEM, (cudaStream_t)stream>>>(
      (const float4*)ptrs[0], (const float4*)ptrs[1], (const float*)ptrs[2], (const int*)ptrs[3],
      n_excl, n_rows, n, row0, degree, q_max, margin, R, (int*)ptrs[4], (int*)ptrs[5],
      (int*)ptrs[6], (int*)ptrs[9], (float*)ptrs[10], (unsigned int*)ptrs[11], (int*)ptrs[7],
      (float*)ptrs[8]);
  return (int)cudaGetLastError();
}

// ptrs: pos, quat, radius, inv_mass, anchor, anchor_quat, slack (1 float),
// then dev_out (2 floats), need_out (1 byte), then scratch: the partials
// (LANE_PARTS floats a group of LANES_WARPS bodies), dv (4 floats a body,
// 16-byte aligned) and the ticket.
int avbd_refresh_needed(void** ptrs, int n, float half_margin, float margin, void* stream) {
  const int blocks = (n + RN_THREADS - 1) / RN_THREADS;
  k_refresh_needed<<<blocks, RN_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)ptrs[0], (const float*)ptrs[1], (const float*)ptrs[2], (const float*)ptrs[3],
      (const float*)ptrs[4], (const float*)ptrs[5], (const float*)ptrs[6], n, half_margin,
      margin, (float*)ptrs[9], (float4*)ptrs[10], (unsigned int*)ptrs[11], (float*)ptrs[7],
      (unsigned char*)ptrs[8]);
  return (int)cudaGetLastError();
}

}  // extern "C"
