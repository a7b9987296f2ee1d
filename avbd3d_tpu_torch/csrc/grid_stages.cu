// The grid step's stages around K5 and K6 on the card: the gates
// (k_grid_gates), the prediction (k_grid_predict) and the finalize
// (k_grid_finalize), one launch each.
//
// None replaces a Pallas kernel: the reference runs these stages as XLA
// inside its jitted step (avbd3d_tpu/solver.py:322-330 the fall-freeze,
// ops/broadphase.py:153-188 the reuse bounds of refresh_or_reuse,
// solver.py:73-112 stale_lhs_ok(refine=False), solver.py:194-231 predict,
// solver_tpu.py:1808-1817 the pose sanitizes and solver.py:234-317
// finalize).  Their plain versions are the port's torch code
// (solver_grid.grid_gates_plain, grid_predict_plain, grid_finalize_plain:
// solver.freeze_fallen, refresh_needed_plain and stale_lhs_ok; predict and
// the (C, G, 128) layout; _sanitize and finalize), which took ~290 launches
// of small torch operations a Stress4096 step.
//
// Every float expression repeats the plain version's statements in their
// order, and the library is built with --fmad=false and IEEE division and
// square root, so frozen fields, poses, quaternions and velocities are the
// plain version's bits.  Two reductions of the plain version are torch's
// own: the quaternion's squared norm in quat_normalize (torch.sum over the
// four components) and the speeds' vector_norm; QUAT_MSQ, VNORM3 and
// VNORM3_XZY (avbd_common.cuh, with the freeze, the prediction's and the
// finalize velocities' halves of one body and the atomic fold, which
// fused_stages.cu shares) write the order in which torch's CUDA reductions
// add those terms (read on the card; the speed lanes are held to 1e-6
// relative where a torch build orders them otherwise).
//
// What bounds them on the H100: launch latency.  Their bytes at N = 5120
// are ~0.4 MB (gates), ~2.5 MB (predict, most of it the stick latches'
// float copy) and ~6 MB (finalize: separations, normal duals, counts, the
// once mask and the latches of the (4, 16, N) slots, the kept mask),
// 0.1-2 us at 3.35 TB/s, below a launch's own few microseconds.  Design:
// one launch each, spread over the card; a cross-block fold ends in a
// ticket: k_grid_gates' blocks hand on their partials, fence and take it
// as in K2 (k_control_lanes); the prediction and the finalize fold by
// atomics into words of scratch (atomic_fold), whose last block reads them,
// writes the result and resets the words and the ticket to 0.  Integer
// sums are exact in any order and the maxima propagate NaN as torch.max
// does, so the flags, the counts and the max lanes equal the plain
// version's.
//
// k_grid_gates, a thread a body: the fall-freeze (linvel, angvel and
// inv_mass with the frozen bodies zeroed, written when the freeze is on),
// then on the frozen state the refresh predicate's two deviations through
// K2's fold (avbd_common.cuh: anchor_terms, fold_group over groups of
// LANES_WARPS bodies, fold_parts_warp's order, dev_mm_block's terms: the
// bits of K2's lanes 3 and 4 and of k_refresh_needed's), and the largest v^2
// of a dynamic body, compared with the two speed bounds in float32.  Writes
// need, stale_ok and calm (1 / 0), dev_mm, dev_raw and v^2 max into one
// buffer, the grid step's one host read.  The deviation net of the mean
// displacement needs the mean first, so the launch is cooperative: after a
// grid barrier every block folds the group partials itself and takes the
// largest deviation of its own bodies from registers, and a ticket folds the
// blocks' maxima (one block once did the whole tail alone, reloading every
// body from L2).

// k_grid_predict, over a grid sized to the card (avbd_grid_predict: a block
// for each 32 bodies, at most two blocks an SM; a thread a latch and a
// thread a body took 1280 blocks at Stress4096, 20 of them doing every
// body's whole chain before a one-warp tail, 4.92 us on the card): eight
// latch warps a block copy the contact cache's stick latches into the 0 / 1
// floats K5 takes, four a thread (a 4-byte load, a 16-byte store); a linear
// and an angular warp a block take 32 bodies each in turn, a lane the
// linear (sanitized linvel, inertial position, warm start) or the angular
// half (clamp, sanitized angvel, inertial quaternion) of a body's
// prediction, written straight into the (C, G, 128) layout K6 reads; the
// sanitize count and the ticket in one 64-bit atomic a block (atomic_count,
// avbd_common.cuh).
//
// k_grid_finalize, over a grid sized to the card (avbd_grid_finalize: at
// most two blocks an SM; its data would ask for 560 blocks of a thread a
// slot at Stress4096): eight slot warps a block walk the slots, the kept
// mask and the six planes of previous velocities (copies), a slot's loads
// issued together, the latches back to bool (wider loads a thread, tried,
// bought nothing and cost registers); two body warps a block take 16
// bodies each in turn (chunk c to block c mod the grid), a lane the linear
// and a lane the angular half of a body's pose sanitize and finalize (each
// half a chain of IEEE divisions and a square root), so the bodies run
// beside the slots on every block instead of after them on the first 20.
// The 16 diagnostics lanes: the maxima of lanes 0-4 over slots and bodies,
// the counts of lanes 5-10 (with the pair overflow cand - kept
// folded in) and CONTROL_RESET in lanes 11-15, by atomic_fold: each block
// folds its threads by warp reductions, then adds its counts and raises its
// maxima (as order-keeping integer keys, NaN above all) in ten words by
// atomics, and the last block to take the ticket reads and clears the
// words.  A last block that folded every block's partials alone, a lane
// walking 18 of them with an L2 round trip each, was most of its 15.5 us
// (PERF.md section 6).
#include "avbd_common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

// ---------------------------------------------------------------------------
// k_grid_gates
// ---------------------------------------------------------------------------

struct GatesArgs {
  const float* pos;       // (3, N)
  const float* quat;      // (4, N)
  const float* lv;        // (3, N)
  const float* av;        // (3, N)
  const float* inv_mass;  // (N)
  const float* radius;    // (N)
  const float* anchor;    // (3, N)
  const float* anchor_q;  // (4, N)
  const float* slack;     // ()
  float* lv_out;          // (3, N) frozen linvel, angvel, inv_mass; null: no fall-freeze
  float* av_out;
  float* im_out;
  float* out;             // need, stale_ok, calm, dev_mm, dev_raw, v2 max
  float* part;            // LANE_PARTS floats a group of LANES_WARPS bodies
  float* part_dev;        // a block's largest |disp - t| + chord
  unsigned int* ticket;
  int n;
  float freeze_y;
  float half_margin;
  float margin;
  float th2;              // lhs_stale_speed_max ** 2
  float calm_th2;         // min(impact_speed_min, lhs_stale_speed_max) ** 2
};

// fold_parts_warp's fold (lane l over groups l, l + 32, ... in index order,
// then the same shuffle tree), with the loads issued GATES_UNROLL at a time:
// the same operations in the same order, so the same bits.
#define GATES_UNROLL 8
__device__ __forceinline__ float fold_parts_ahead(const float* part, int n_groups, int k, int lane) {
  const int op = part_op(k);
  float v = F(0.0);
  for (int b0 = lane; b0 < n_groups; b0 += 32 * GATES_UNROLL) {
    float x[GATES_UNROLL];
#pragma unroll
    for (int u = 0; u < GATES_UNROLL; ++u) {
      const int b = b0 + 32 * u;
      x[u] = b < n_groups ? __ldcg(part + b * LANE_PARTS + k) : F(0.0);
    }
#pragma unroll
    for (int u = 0; u < GATES_UNROLL; ++u)
      if (b0 + 32 * u < n_groups) v = fold(op, v, x[u]);
  }
  for (int off = 16; off > 0; off >>= 1) v = fold(op, v, __shfl_xor_sync(FULL_MASK, v, off));
  return v;
}

// One cooperative launch (every block resident; the launcher checks).  Pass
// 1, a thread a body: the freeze, the anchor terms and the group partials,
// as before.  Then a grid barrier, after which every block folds the group
// partials itself in the one fixed order (so every block has the same t),
// takes the largest |disp - t| + chord over its own bodies from the terms it
// kept in registers, and hands it on by a ticket: the last block folds the
// blocks' maxima (a max: exact in any order), writes the six lanes and
// resets the ticket.
__global__ void __launch_bounds__(STAGE_THREADS) k_grid_gates(GatesArgs a) {
  __shared__ float sh[LANE_PARTS][STAGE_THREADS];
  __shared__ float sh_fold[LANE_PARTS];
  __shared__ float sh_dev[STAGE_WARPS];
  __shared__ bool sh_last;
  const int n = a.n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * STAGE_THREADS + threadIdx.x;
  AnchorTerms t;
  t.moved = false;
  if (i < n) {
    V3 pos = ld3(a.pos, i, n), lv = ld3(a.lv, i, n), av = ld3(a.av, i, n);
    float im = a.inv_mass[i];
    if (a.lv_out != nullptr) {
      freeze_body(pos, a.freeze_y, &lv, &av, &im);
      st3(a.lv_out, i, n, lv);
      st3(a.av_out, i, n, av);
      a.im_out[i] = im;
    }
    const bool dyn = im > F(0.0);
    t = anchor_terms(pos, ld4(a.quat, i, n), ld3(a.anchor, i, n), ld4(a.anchor_q, i, n),
                     a.radius[i], dyn);
    const float mf = t.moved ? F(1.0) : F(0.0);
    sh[1][threadIdx.x] = dyn ? lv.x * lv.x + lv.y * lv.y + lv.z * lv.z : F(0.0);
    sh[3][threadIdx.x] = t.moved ? sqrtf(t.disp2) + t.chord : F(0.0);
    sh[4][threadIdx.x] = mf;
    sh[5][threadIdx.x] = t.disp.x * mf;
    sh[6][threadIdx.x] = t.disp.y * mf;
    sh[7][threadIdx.x] = t.disp.z * mf;
  } else {
    for (int k = 1; k < LANE_PARTS; ++k) sh[k][threadIdx.x] = F(0.0);
  }
  __syncthreads();
  // One thread a (group, partial): the group's bodies in order, as K2 folds
  // them.
  const int groups = STAGE_THREADS / LANES_WARPS;
  if (threadIdx.x < groups * 6) {
    const int g = threadIdx.x / 6, j = threadIdx.x % 6;
    const int k = j == 0 ? 1 : j + 2;
    const int gg = blockIdx.x * groups + g;
    if (gg * LANES_WARPS < n) {
      const float v = fold_group(&sh[k][g * LANES_WARPS], part_op(k));
      RACE_DELAY();
      a.part[gg * LANE_PARTS + k] = v;
    }
  }
  cg::this_grid().sync();
  RACE_DELAY();
  const int n_groups = (n + LANES_WARPS - 1) / LANES_WARPS;
  if (warp == 1 || (warp >= 3 && warp < LANE_PARTS)) {
    const float v = fold_parts_ahead(a.part, n_groups, warp, lane);
    if (lane == 0) sh_fold[warp] = v;
  }
  __syncthreads();
  const float nmc = fmaxf(sh_fold[4], F(1.0));
  const V3 tm = v3(sh_fold[5] / nmc, sh_fold[6] / nmc, sh_fold[7] / nmc);
  // dev_mm_block's terms, over this block's bodies.
  float dev_mm = F(0.0);
  if (t.moved) {
    const V3 e = v3(t.disp.x - tm.x, t.disp.y - tm.y, t.disp.z - tm.z);
    dev_mm = max_nan(dev_mm, sqrtf(e.x * e.x + e.y * e.y + e.z * e.z) + t.chord);
  }
  for (int off = 16; off > 0; off >>= 1)
    dev_mm = max_nan(dev_mm, __shfl_xor_sync(FULL_MASK, dev_mm, off));
  if (lane == 0) sh_dev[warp] = dev_mm;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < STAGE_WARPS; ++w) dev_mm = max_nan(dev_mm, sh_dev[w]);
    RACE_DELAY();
    a.part_dev[blockIdx.x] = dev_mm;
    __threadfence();
    RACE_DELAY();
    sh_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!sh_last || warp != 0) return;
  __threadfence();
  dev_mm = F(0.0);
  for (int b = lane; b < (int)gridDim.x; b += 32) dev_mm = max_nan(dev_mm, __ldcg(a.part_dev + b));
  for (int off = 16; off > 0; off >>= 1)
    dev_mm = max_nan(dev_mm, __shfl_xor_sync(FULL_MASK, dev_mm, off));
  if (lane == 0) {
    const float dev_raw = sh_fold[3], v2 = sh_fold[1];
    a.out[0] = (dev_mm > a.half_margin) || (dev_raw > *a.slack + a.margin) ? F(1.0) : F(0.0);
    a.out[1] = v2 <= a.th2 ? F(1.0) : F(0.0);
    a.out[2] = v2 <= a.calm_th2 ? F(1.0) : F(0.0);
    a.out[3] = dev_mm;
    a.out[4] = dev_raw;
    a.out[5] = v2;
    *a.ticket = 0u;
  }
}

// ---------------------------------------------------------------------------
// k_grid_predict
// ---------------------------------------------------------------------------

#define PRED_LATCH_WARPS 8  // warps a block for the latch copy
#define PRED_BODY_WARPS 2   // a linear and an angular warp a block for the bodies
#define PRED_WARPS (PRED_LATCH_WARPS + PRED_BODY_WARPS)
#define PRED_THREADS (32 * PRED_WARPS)
#define PRED_LATCH_UNROLL 2  // latch groups of 4 a latch thread loads before it stores

struct PredictArgs {
  const float* pos;       // (3, N)
  const float* quat;      // (4, N)
  const float* lv;        // (3, N)
  const float* av;        // (3, N)
  const float* prev_lv;   // (3, N)
  const float* inv_mass;  // (N)
  const unsigned char* stick;  // (planes, N) bool
  float* lv_out;          // (3, N) sanitized linvel
  float* av_out;          // (3, N) clamped, sanitized angvel
  float* ip;              // (3, N) inertial position
  float* iq;              // (4, N) inertial quaternion (also the start)
  float* ps;              // (3, N) warm start position
  float* stickf;          // (planes, N) 0 / 1
  int* san_out;           // () rows sanitized
  unsigned long long* fold;  // the count (high) and the ticket (low): 0 before and after a launch
  int n;
  int planes;             // 4 * DC
};

// Four latches (the bytes of x) as 0 / 1 floats.
__device__ __forceinline__ float4 latch4(unsigned int x) {
  return make_float4((x & 0xffu) ? F(1.0) : F(0.0), (x & 0xff00u) ? F(1.0) : F(0.0),
                     (x & 0xff0000u) ? F(1.0) : F(0.0), (x & 0xff000000u) ? F(1.0) : F(0.0));
}

// Latch warp w of block b (global latch warp g = b + gridDim.x * w): groups
// of 4 latches 32 g + lane, + stride, ..., a 4-byte load and a 16-byte store
// each, PRED_LATCH_UNROLL loads issued before their stores; then the
// latches past the last whole group (and every latch, a thread one, where
// the buffers are not aligned for the wide accesses).  Body warp 2c + h of
// the grid (c = b + gridDim.x r): bodies 32 c .. 32 c + 31, the linear (h =
// 0) or the angular (h = 1) half of their prediction, a lane a body
// (tests/test_torch_port.py models these loops).  The sanitize count by
// atomic_count.
__global__ void __launch_bounds__(PRED_THREADS) k_grid_predict(PredictArgs a, KParams p) {
  __shared__ unsigned int shc[PRED_WARPS];
  const int n = a.n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int san = 0;
  if (warp < PRED_LATCH_WARPS) {
    const int total = a.planes * n;
    const bool wide = ((reinterpret_cast<size_t>(a.stick) & 3) |
                       (reinterpret_cast<size_t>(a.stickf) & 15)) == 0;
    const int groups = wide ? total / 4 : 0;
    const int stride = gridDim.x * PRED_LATCH_WARPS * 32;
    const int first = (blockIdx.x + gridDim.x * warp) * 32 + lane;
    const unsigned int* src = reinterpret_cast<const unsigned int*>(a.stick);
    float4* dst = reinterpret_cast<float4*>(a.stickf);
    for (int u0 = first; u0 < groups; u0 += PRED_LATCH_UNROLL * stride) {
      unsigned int x[PRED_LATCH_UNROLL];
#pragma unroll
      for (int k = 0; k < PRED_LATCH_UNROLL; ++k) {
        const int u = u0 + k * stride;
        x[k] = u < groups ? __ldg(src + u) : 0u;
      }
#pragma unroll
      for (int k = 0; k < PRED_LATCH_UNROLL; ++k) {
        const int u = u0 + k * stride;
        if (u < groups) dst[u] = latch4(x[k]);
      }
    }
    for (int t = 4 * groups + first; t < total; t += stride)
      a.stickf[t] = a.stick[t] ? F(1.0) : F(0.0);
  } else {
    const bool angular = warp - PRED_LATCH_WARPS == 1;
    for (int c = blockIdx.x; 32 * c < n; c += gridDim.x) {
      const int i = 32 * c + lane;
      if (i >= n) break;
      const bool dyn = a.inv_mass[i] > F(0.0);
      if (!angular) {
        const PredLinear r = predict_linear(ld3(a.pos, i, n), ld3(a.lv, i, n),
                                            ld3(a.prev_lv, i, n), dyn, p, &san);
        st3(a.lv_out, i, n, r.lv);
        st3(a.ip, i, n, r.ip);
        st3(a.ps, i, n, r.ps);
      } else {
        const PredAngular r = predict_angular(ld4(a.quat, i, n), ld3(a.av, i, n), dyn, p, &san);
        st3(a.av_out, i, n, r.av);
        st4(a.iq, i, n, r.iq);
      }
    }
  }
  int total;
  if (!atomic_count(san, shc, a.fold, &total)) return;
  *a.san_out = total;
  *a.fold = 0ull;
}

// ---------------------------------------------------------------------------
// k_grid_finalize
// ---------------------------------------------------------------------------

#define FIN_F 5  // max lanes: penetration, violation, linear speed, angular speed, normal dual
#define FIN_I 5  // counts: contacts, manifolds, dynamic bodies, sanitized rows, kept slots
#define FIN_BODY_WARPS 2  // warps a block for the bodies, besides STAGE_WARPS for the slots
#define FIN_WARPS (STAGE_WARPS + FIN_BODY_WARPS)
#define FIN_THREADS (32 * FIN_WARPS)

struct FinalizeArgs {
  const float* pos_k;     // (3, N) K6's last poses
  const float* quat_k;    // (4, N)
  const float* pos0;      // (3, N) the step's start poses
  const float* quat0;     // (4, N)
  const float* lv0;       // (3, N) the bodies' velocities (kept by static bodies)
  const float* av0;
  const float* lv_p;      // (3, N) the prediction's sanitized velocities
  const float* av_p;
  const float* prev_lv;   // (3, N) the bodies' previous velocities
  const float* prev_av;
  const float* inv_mass;  // (N)
  const int* san_in;      // () the prediction's count
  const int* count;       // (DC, N)
  const int* other;       // (DC, N)
  const float* sep;       // (4, DC, N)
  const float* lam;       // (12, DC, N)
  const unsigned char* once;   // (DC, N) bool
  const float* stickf;    // (4, DC, N) K6's latches
  const float* kept;      // (D, N) K5's kept mask
  const int* cand;        // () directed candidates at the refresh
  const int* dropped;     // () K5's dropped manifolds
  float* pos;             // (3, N) outputs
  float* quat;
  float* lv;
  float* av;
  float* prev_lv_out;
  float* prev_av_out;
  unsigned char* stick;   // (4, DC, N) bool
  float* diag;            // (16)
  unsigned int* fold;     // FIN_F + FIN_I words, then the ticket: 0 before and after a launch
  int n;
  int dc;
  int d;
};

// Bodies 16c .. 16c + 15 of chunk c, lane l of a body warp the linear half
// (l < 16) or the angular half (l >= 16) of body 16c + l % 16: its pose
// sanitize and finalize velocity, its outputs written, its speed into
// fv[2] / fv[3], the dynamic count (the linear lane) and its sanitize
// count into iv[2] / iv[3].  Every load comes before the arithmetic.
__device__ __forceinline__ void finalize_half(const FinalizeArgs& a, const KParams& p, int i,
                                              bool angular, float (&fv)[FIN_F],
                                              int (&iv)[FIN_I]) {
  const int n = a.n;
  const bool dyn = a.inv_mass[i] > F(0.0);
  int san = 0;
  if (!angular) {
    const V3 pos0 = ld3(a.pos0, i, n), lv0 = ld3(a.lv0, i, n);
    V3 pf = ld3(a.pos_k, i, n);
    if (i == 0) san = *a.san_in;  // the prediction's count, once
    if (!finite3(pf)) {
      pf = pos0;
      ++san;
    }
    const V3 nl = finalize_linear(pf, pos0, lv0, dyn, p, &san);
    fv[2] = max_nan(fv[2], VNORM3(nl) * (dyn ? F(1.0) : F(0.0)));
    iv[2] += dyn ? 1 : 0;
    st3(a.pos, i, n, pf);
    st3(a.lv, i, n, nl);
  } else {
    const Q4 q0 = ld4(a.quat0, i, n);
    const V3 av0 = ld3(a.av0, i, n);
    Q4 qf = ld4(a.quat_k, i, n);
    if (!finite4(qf)) {
      qf = q0;
      ++san;
    }
    const V3 na = finalize_angular(qf, q0, av0, dyn, p, &san);
    fv[3] = max_nan(fv[3], VNORM3_XZY(na) * (dyn ? F(1.0) : F(0.0)));
    st4(a.quat, i, n, qf);
    st3(a.av, i, n, na);
  }
  iv[3] += san;
}

// Slot thread t of the grid (STAGE_THREADS a block; stride: all of them)
// takes slot, kept and previous-velocity entries t, t + stride, ...; body
// warp w of block b the chunks of 16 bodies c = b + gridDim.x * (w +
// FIN_BODY_WARPS r) (tests/test_torch_port.py models these loops).
__global__ void __launch_bounds__(FIN_THREADS) k_grid_finalize(FinalizeArgs a, KParams p) {
  __shared__ unsigned int shk[FIN_F + FIN_I][FIN_WARPS];
  const int n = a.n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float fv[FIN_F] = {F(0.0), F(0.0), F(0.0), F(0.0), F(0.0)};
  int iv[FIN_I] = {0, 0, 0, 0, 0};
  // Lanes 9 and 10 of warp 0 read the counts their lanes subtract and copy
  // now, so that the last block does not wait on them.
  int scalar = 0;
  if (threadIdx.x == 9) scalar = *a.cand;
  if (threadIdx.x == 10) scalar = *a.dropped;
  if (warp < STAGE_WARPS) {
    const int slots = a.dc * n, kept = a.d * n;
    const int entries = max(max(slots, kept), 6 * n);
    const int plane = slots;
    const int stride = gridDim.x * STAGE_THREADS;
    for (int t = blockIdx.x * STAGE_THREADS + threadIdx.x; t < entries; t += stride) {
      const float km = t < kept ? a.kept[t] : F(0.0);
      if (t < 6 * n) {  // a previous velocity: the prediction's for a dynamic body
        const int c = t / n, i = t - c * n;
        const bool dyn = a.inv_mass[i] > F(0.0);
        const float xp = (c < 3 ? a.lv_p : a.av_p)[(c % 3) * n + i];
        const float xq = (c < 3 ? a.prev_lv : a.prev_av)[(c % 3) * n + i];
        (c < 3 ? a.prev_lv_out : a.prev_av_out)[(c % 3) * n + i] = dyn ? xp : xq;
      }
      if (t < slots) {  // slot t: the contact lanes and the latches
        const int cnt = a.count[t];
        const bool valid = a.other[t] >= 0, once = a.once[t] != 0;
        float sep[4], lam[4], sf[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          sep[s] = a.sep[s * plane + t];
          lam[s] = a.lam[3 * s * plane + t];
          sf[s] = a.stickf[s * plane + t];
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const bool ok = s < cnt && valid;
          fv[0] = max_nan(fv[0], ok ? -sep[s] : F(0.0));
          fv[1] = max_nan(fv[1], ok ? p.penetration_slop - sep[s] : F(0.0));
          fv[4] = max_nan(fv[4], ok ? fabsf(lam[s]) : F(0.0));
          a.stick[s * plane + t] = sf[s] > F(0.5) ? 1 : 0;
        }
        iv[0] += once ? cnt : 0;
        iv[1] += once && cnt > 0 ? 1 : 0;
      }
      iv[4] += (int)km;
    }
  } else {
    const int chunks = (n + 15) / 16;
    for (int c = blockIdx.x + gridDim.x * (warp - STAGE_WARPS); c < chunks;
         c += gridDim.x * FIN_BODY_WARPS) {
      const int i = c * 16 + (lane & 15);
      if (i < n) finalize_half(a, p, i, lane >= 16, fv, iv);
    }
  }
  unsigned int q[FIN_F + FIN_I];
#pragma unroll
  for (int k = 0; k < FIN_F; ++k) q[k] = max_key(fv[k]);
#pragma unroll
  for (int k = 0; k < FIN_I; ++k) q[FIN_F + k] = (unsigned int)iv[k];
  unsigned int w;
  if (!atomic_fold<FIN_F>(q, shk, a.fold, &w)) return;
  // Warp 0 of the last block: lane k writes lane k of the diagnostics.
  float* dg = a.diag;
  if (lane < FIN_F) dg[lane] = max_of_key(w);
  else if (lane < 9) dg[lane] = (float)(int)w;   // contacts, manifolds, dynamic, sanitized
  else if (lane == 9) dg[9] = (float)(scalar - (int)w);
  else if (lane == 10) dg[10] = (float)scalar;
  else if (lane < 16) dg[lane] = lane == 13 ? F(0.0) : F(1.0e9);  // state.CONTROL_RESET
}

extern "C" {

// ptrs: pos, quat, linvel, angvel, inv_mass, radius, anchor, anchor_quat,
// slack, then the frozen linvel, angvel, inv_mass (null each without the
// fall-freeze), out (6 floats), then scratch: the partials (LANE_PARTS floats
// a group of LANES_WARPS bodies), a float a block (its largest deviation)
// and the ticket (0 before the launch and after it).  A cooperative launch;
// cudaErrorCooperativeLaunchTooLarge when the blocks cannot all be resident.
int avbd_grid_gates(void** ptrs, int n, float freeze_y, float half_margin, float margin,
                    float th2, float calm_th2, void* stream) {
  GatesArgs a;
  a.pos = (const float*)ptrs[0];
  a.quat = (const float*)ptrs[1];
  a.lv = (const float*)ptrs[2];
  a.av = (const float*)ptrs[3];
  a.inv_mass = (const float*)ptrs[4];
  a.radius = (const float*)ptrs[5];
  a.anchor = (const float*)ptrs[6];
  a.anchor_q = (const float*)ptrs[7];
  a.slack = (const float*)ptrs[8];
  a.lv_out = (float*)ptrs[9];
  a.av_out = (float*)ptrs[10];
  a.im_out = (float*)ptrs[11];
  a.out = (float*)ptrs[12];
  a.part = (float*)ptrs[13];
  a.part_dev = (float*)ptrs[14];
  a.ticket = (unsigned int*)ptrs[15];
  a.n = n;
  a.freeze_y = freeze_y;
  a.half_margin = half_margin;
  a.margin = margin;
  a.th2 = th2;
  a.calm_th2 = calm_th2;
  const int blocks = (n + STAGE_THREADS - 1) / STAGE_THREADS;
  // The grid barrier needs every block resident at once: at most this many.
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_grid_gates, STAGE_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    resident = per_sm * sms;
  }
  if (blocks > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)k_grid_gates, dim3(blocks), dim3(STAGE_THREADS),
                                          args, 0, (cudaStream_t)stream);
}

// ptrs: pos, quat, linvel, angvel, prev_linvel, inv_mass, stick (planes x
// N bool), then linvel, angvel, ip, iq, ps, stickf, sanitized (1 int), then
// scratch: the count's and the ticket's 64-bit word (0 before the launch
// and after it).  The grid: a block for each 32 bodies or for each PRED_LATCH_UNROLL
// groups of 4 latches a latch thread, whichever is more, at most
// STAGE_BLOCKS_PER_SM blocks an SM; the warps stride over the rest.
// AVBD_PRED_BLOCKS (kernels.build's defines, for checks and comparisons
// only) sets another grid.
int avbd_grid_predict(void** ptrs, const float* params, int n, int planes, void* stream) {
  PredictArgs a;
  a.pos = (const float*)ptrs[0];
  a.quat = (const float*)ptrs[1];
  a.lv = (const float*)ptrs[2];
  a.av = (const float*)ptrs[3];
  a.prev_lv = (const float*)ptrs[4];
  a.inv_mass = (const float*)ptrs[5];
  a.stick = (const unsigned char*)ptrs[6];
  a.lv_out = (float*)ptrs[7];
  a.av_out = (float*)ptrs[8];
  a.ip = (float*)ptrs[9];
  a.iq = (float*)ptrs[10];
  a.ps = (float*)ptrs[11];
  a.stickf = (float*)ptrs[12];
  a.san_out = (int*)ptrs[13];
  a.fold = (unsigned long long*)ptrs[14];
  a.n = n;
  a.planes = planes;
  KParams p = *(const KParams*)params;
#ifdef AVBD_PRED_BLOCKS
  const int blocks = AVBD_PRED_BLOCKS;
#else
  const int per_block = 32 * PRED_LATCH_WARPS * PRED_LATCH_UNROLL;
  const int latch_blocks = (planes * n / 4 + per_block - 1) / per_block;
  const int body_blocks = (n + 31) / 32;
  int blocks = 0;
  const cudaError_t err = stage_grid(latch_blocks > body_blocks ? latch_blocks : body_blocks,
                                     &blocks);
  if (err != cudaSuccess) return (int)err;
#endif
  k_grid_predict<<<blocks, PRED_THREADS, 0, (cudaStream_t)stream>>>(a, p);
  return (int)cudaGetLastError();
}

// ptrs: pos_k, quat_k, pos0, quat0, linvel, angvel, lv_p, av_p,
// prev_linvel, prev_angvel, inv_mass, sanitized (1 int), count, other,
// sep, lam, once, stickf, kept, cand (1 int), dropped (1 int), then pos,
// quat, linvel, angvel, prev_linvel, prev_angvel, stick (bool), diag (16
// floats), then scratch: FIN_F + FIN_I fold words and the ticket (0 before
// the launch and after it).  The grid: a slot thread (STAGE_THREADS a
// block) for each entry of the widest plane set (DC or D slots a body, or
// the 6 planes of previous velocities), at most STAGE_BLOCKS_PER_SM blocks an
// SM; the threads stride over the rest.  AVBD_FIN_BLOCKS (kernels.build's
// defines, for checks and comparisons only) sets another grid.
int avbd_grid_finalize(void** ptrs, const float* params, int n, int dc, int d, void* stream) {
  FinalizeArgs a;
  a.pos_k = (const float*)ptrs[0];
  a.quat_k = (const float*)ptrs[1];
  a.pos0 = (const float*)ptrs[2];
  a.quat0 = (const float*)ptrs[3];
  a.lv0 = (const float*)ptrs[4];
  a.av0 = (const float*)ptrs[5];
  a.lv_p = (const float*)ptrs[6];
  a.av_p = (const float*)ptrs[7];
  a.prev_lv = (const float*)ptrs[8];
  a.prev_av = (const float*)ptrs[9];
  a.inv_mass = (const float*)ptrs[10];
  a.san_in = (const int*)ptrs[11];
  a.count = (const int*)ptrs[12];
  a.other = (const int*)ptrs[13];
  a.sep = (const float*)ptrs[14];
  a.lam = (const float*)ptrs[15];
  a.once = (const unsigned char*)ptrs[16];
  a.stickf = (const float*)ptrs[17];
  a.kept = (const float*)ptrs[18];
  a.cand = (const int*)ptrs[19];
  a.dropped = (const int*)ptrs[20];
  a.pos = (float*)ptrs[21];
  a.quat = (float*)ptrs[22];
  a.lv = (float*)ptrs[23];
  a.av = (float*)ptrs[24];
  a.prev_lv_out = (float*)ptrs[25];
  a.prev_av_out = (float*)ptrs[26];
  a.stick = (unsigned char*)ptrs[27];
  a.diag = (float*)ptrs[28];
  a.fold = (unsigned int*)ptrs[29];
  a.n = n;
  a.dc = dc;
  a.d = d;
  KParams p = *(const KParams*)params;
#ifdef AVBD_FIN_BLOCKS
  const int blocks = AVBD_FIN_BLOCKS;
#else
  const int rows = dc > d ? (dc > 6 ? dc : 6) : (d > 6 ? d : 6);
  int blocks = 0;
  const cudaError_t err = stage_grid((rows * n + STAGE_THREADS - 1) / STAGE_THREADS, &blocks);
  if (err != cudaSuccess) return (int)err;
#endif
  k_grid_finalize<<<blocks, FIN_THREADS, 0, (cudaStream_t)stream>>>(a, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
