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
// the bytes are the 32-byte column table, N^2 reads of it from L2 and one
// from device memory.  Design, simple first:
//
// 1. k_bp_tables, a thread a body: the world-AABB halves (world_halves,
//    the plain version's operations), written with the centre, radius and
//    dynamic flag as one 32-byte table row (two float4), and the largest
//    half extent folded by the last block to finish (a ticket), which fixes
//    the keys' range and scale.
// 2. k_bp_lists, a block a row: every column's key, or INT32_MAX for an
//    unmasked one, into shared memory (N int32: 20 KB at N = 5120, 64 KB at
//    16384); the block's count and slack; when the row has more than D
//    candidates, the D-th smallest key by bisection on the key's value (the
//    keys are unique, so each round counts the keys <= mid); the selected
//    keys (<= that key) compacted into shared memory, each written at its
//    rank among them (<= D^2 comparisons).  Rows of static bodies (the
//    ground, padding) select nothing and skip the columns.  Each block
//    writes its count, kept slots and slack; the last block to finish folds
//    them in index order (integer sums and a min: exact in any order) into
//    cand, kept, dropped = cand - kept and slack.
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

// rows: n_rows table rows (global ids row0 ..), cols: n table rows (every
// body); excl: (n_excl, n_rows) partners each row must not list (-1 none).
// nb, key: (degree, n_rows); thr: (n_rows); part_cnt: (cand, kept) a row;
// part_slack: a float a row; ticket: 0 at launch, 0 after; out_i: cand,
// kept, dropped; out_slack: the slack.  Dynamic shared memory: n + n_excl
// ints.  Each per world (blockIdx.y).
__global__ void __launch_bounds__(BPL_THREADS)
k_bp_lists(const float4* rows, const float4* cols, const float* max_wh, const int* excl,
           int n_excl, int n_rows, int n, int row0, int degree, int q_max, float margin, int* nb,
           int* key, int* thr, int* part_cnt, float* part_slack, unsigned int* ticket,
           int* out_i, float* out_slack) {
  extern __shared__ int sh_key[];
  __shared__ int sh_sel[BP_MAX_DEGREE];
  __shared__ int sh_red[2][BPL_WARPS];
  __shared__ float sh_redf[BPL_WARPS];
  __shared__ int sh_nsel;
  __shared__ bool sh_last;
  const size_t w = blockIdx.y;
  rows += w * 2 * n_rows;
  cols += w * 2 * n;
  max_wh += w;
  excl += w * n_excl * n_rows;
  nb += w * degree * n_rows;
  key += w * degree * n_rows;
  thr += w * n_rows;
  part_cnt += w * 2 * n_rows;
  part_slack += w * n_rows;
  ticket += w;
  out_i += w * 3;
  out_slack += w;
  int* ex = sh_key + n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x;
  const float4 rc = rows[2 * i], rw = rows[2 * i + 1];
  const bool dyn_i = rw.w > F(0.0);
  int cand_row = 0, nsel = 0;
  float slack_row = F(1.0e9);
  if (dyn_i) {  // block-uniform
    const int gi = row0 + i;
    // _key_packing: the range and the scale, a float32 division.
    const float gap_range = fmaxf(F(2.0) * *max_wh + margin, F(1e-6));
    const float qmax_f = (float)q_max;
    const float scale = qmax_f / gap_range;
    for (int e = threadIdx.x; e < n_excl; e += blockDim.x) ex[e] = excl[(size_t)e * n_rows + i];
    __syncthreads();
    int cnt = 0;
    float smin = F(1.0e9);
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float4 pc = cols[2 * j], pw = cols[2 * j + 1];
      // _cheb_gap, _real_pair, the mask and _keys in the plain version's order.
      float gap = fmaxf(fmaxf(fabsf(rc.x - pc.x) - (rw.x + pw.x),
                              fabsf(rc.y - pc.y) - (rw.y + pw.y)),
                        fabsf(rc.z - pc.z) - (rw.z + pw.z)) - margin;
      bool real = rc.w + pc.w + margin > margin;
      bool other = j != gi;
      bool m = gap <= F(0.0) && real && other;
      for (int e = 0; e < n_excl; ++e) m = m && j != ex[e];
      int k = KEY_NONE;
      if (m) {
        k = (int)clipf((gap + gap_range) * scale, F(0.0), qmax_f) * n + j;
        ++cnt;
      }
      if (pw.w == F(0.0) && real && gap > F(0.0) && other) smin = fminf(smin, gap);
      sh_key[j] = k;
    }
    cnt = warp_sum(cnt);
    for (int off = 16; off > 0; off >>= 1)
      smin = fminf(smin, __shfl_xor_sync(FULL_MASK, smin, off));
    if (lane == 0) {
      sh_red[0][warp] = cnt;
      sh_redf[warp] = smin;
    }
    __syncthreads();
    for (int k = 0; k < BPL_WARPS; ++k) {
      cand_row += sh_red[0][k];
      slack_row = fminf(slack_row, sh_redf[k]);
    }
    if (cand_row > 0) {
      // Keys <= sel_max are the row's selection: every key when the row has
      // at most D, else the smallest v with D keys <= v (the D-th key).
      int sel_max = KEY_NONE - 1;
      if (cand_row > degree) {
        int lo = -1, hi = KEY_NONE - 1, buf = 1;
        while (hi - lo > 1) {
          const int mid = lo + (hi - lo) / 2;
          int c = 0;
          for (int j = threadIdx.x; j < n; j += blockDim.x) c += sh_key[j] <= mid;
          c = warp_sum(c);
          if (lane == 0) sh_red[buf][warp] = c;
          __syncthreads();
          int tot = 0;
          for (int k = 0; k < BPL_WARPS; ++k) tot += sh_red[buf][k];
          if (tot >= degree) hi = mid;
          else lo = mid;
          buf ^= 1;
        }
        sel_max = hi;
      }
      if (threadIdx.x == 0) sh_nsel = 0;
      __syncthreads();
      for (int j = threadIdx.x; j < n; j += blockDim.x) {
        const int k = sh_key[j];
        if (k <= sel_max) {
          const int at = atomicAdd(&sh_nsel, 1);
          if (at < degree) sh_sel[at] = k;
        }
      }
      __syncthreads();
      nsel = min(sh_nsel, degree);
    }
  }
  // Slot d of the row: the selected key of rank d, ascending; -1 / 0 past
  // the selection.  The threshold: the D-th key, or none.
  for (int t = threadIdx.x; t < degree; t += blockDim.x) {
    if (t < nsel) {
      const int k = sh_sel[t];
      int rank = 0;
      for (int s = 0; s < nsel; ++s) rank += sh_sel[s] < k;
      nb[(size_t)rank * n_rows + i] = k % n;
      key[(size_t)rank * n_rows + i] = k;
      if (rank == degree - 1) thr[i] = k;
    } else {
      nb[(size_t)t * n_rows + i] = -1;
      key[(size_t)t * n_rows + i] = 0;
    }
  }
  if (threadIdx.x == 0) {
    if (nsel < degree) thr[i] = KEY_NONE;
    RACE_DELAY();
    part_cnt[2 * i] = cand_row;
    part_cnt[2 * i + 1] = nsel;
    part_slack[i] = slack_row;
    __threadfence();
    RACE_DELAY();
    sh_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!sh_last) return;
  // The last block: every row's partials are visible (each fenced before
  // its ticket); read them from L2, past this SM's L1.
  __threadfence();
  int c_sum = 0, k_sum = 0;
  float s_min = F(1.0e9);
  for (int r = threadIdx.x; r < n_rows; r += blockDim.x) {
    c_sum += __ldcg(part_cnt + 2 * r);
    k_sum += __ldcg(part_cnt + 2 * r + 1);
    s_min = fminf(s_min, __ldcg(part_slack + r));
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
// dropped), out_slack, then scratch: part_cnt (2 ints a row), part_slack (a
// float a row) and the ticket; each per world of ``batch``.  The dynamic
// shared memory (n + n_excl ints) is raised past 48 KB when it must be.
int avbd_bp_lists(void** ptrs, int n_rows, int n, int row0, int degree, int n_excl, int q_max,
                  float margin, int batch, void* stream) {
  if (degree < 1 || degree > BP_MAX_DEGREE) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(n + n_excl) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(k_bp_lists, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  k_bp_lists<<<dim3(n_rows, batch), BPL_THREADS, smem, (cudaStream_t)stream>>>(
      (const float4*)ptrs[0], (const float4*)ptrs[1], (const float*)ptrs[2], (const int*)ptrs[3],
      n_excl, n_rows, n, row0, degree, q_max, margin, (int*)ptrs[4], (int*)ptrs[5],
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
