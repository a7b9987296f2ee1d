// K2: the control-lanes kernel.
//
// Replaces control_lanes_tpu / _make_kernel_control
// (avbd3d_tpu/solver_tpu.py:235-273; math ops/broadphase.py:785-851): the five
// step-control scalars (diagnostics lanes 11-15) on the current state, run on
// every contact-free (ballistic) step.
//
// What bounds it on the H100: latency.  The work is a (D, N) slot scan
// (~100 KB read at N = 1024, D = 24; ~40 float operations a slot) and two
// reductions over N <= 2048 bodies, microseconds below a launch's own cost;
// what is left is each slot's dependent chain (two gathers, the partner's
// world halves and travel).  Design: one launch spread over the card.  Pass 1
// takes a warp per body and a lane per candidate slot (lanes stride over the
// slots when D > 32): each lane computes its slot's AABB gap and near test in
// the plain version's order, the warp takes min_nan of the valid gaps and
// __any_sync of near, and lane 0 adds the body's own terms (the gate speed
// with the fall-freeze test, the displacement from the anchor, moved, the
// rotation chord and the raw deviation, which needs no mean) and stores the
// body's displacement and chord for pass 2.  Each block folds its 8 bodies
// in body order into 8 partials: min gap, gate, near speed, raw deviation,
// moved count and the three displacement sums.  The last block to finish (a
// ticket taken after a __threadfence) folds every block's partials, warp k
// quantity k, each lane over the blocks lane, lane + 32, ... in index order
// and then a fixed shuffle tree, computes the mean displacement t and runs
// pass 2 (|disp - t| + chord over every moved body, a max), writes the five
// lanes and resets the ticket to 0.  Every sum is taken in one fixed order,
// so a run gives the same bits every time; min and max are exact in any
// order, so lanes 0, 1, 2 and 4 equal the plain version's
// (ops/broadphase.control_lanes) bit for bit, and only lane 3 (bp_dev_mm,
// through t) rounds otherwise than torch.sum.  Every min and max keeps a
// NaN (max_nan, min_nan), as torch.maximum / torch.min / torch.max do, so
// a NaN pose gives the plain version's NaN lanes.  No float atomics.
// control_lanes_block (avbd_common.cuh), K1's one-block form in
// k_final_reduce, is not used here.
//
// A batch of B worlds (parallel.batched) is one launch with grid.y = B:
// block (x, y) does world y's block x on world y's slices of every operand,
// partials, dv, ticket and output, so each world's lanes are the bits one
// launch on that world alone gives.
#include "avbd_common.cuh"

// World w's operands in a batch whose worlds lie one after another.
__device__ __forceinline__ CtrlIn ctrl_world(CtrlIn in, int w) {
  const size_t n = in.n, off = (size_t)w * n;
  in.nb += off * in.d;
  in.pos += off * 3;
  in.quat += off * 4;
  in.size += off * 3;
  in.radius += off;
  in.lv += off * 3;
  in.av += off * 3;
  in.inv_mass += off;
  in.anchor += off * 3;
  in.anchor_q += off * 4;
  return in;
}

// part: LANE_PARTS floats per block; dv: per body (disp.x, disp.y, disp.z,
// chord), chord -1 for a body that has not moved; ticket: 0 at launch, 0
// after; out: the 5 lanes.  Each of these per world (blockIdx.y).
__global__ void __launch_bounds__(LANES_WARPS * 32)
k_control_lanes(CtrlIn in_all, KParams p, float* part, float4* dv, unsigned int* ticket,
                float* out) {
  const CtrlIn in = ctrl_world(in_all, blockIdx.y);
  part += (size_t)blockIdx.y * gridDim.x * LANE_PARTS;
  dv += (size_t)blockIdx.y * in.n;
  ticket += blockIdx.y;
  out += blockIdx.y * 5;
  __shared__ float sh[LANE_PARTS][LANES_WARPS];
  __shared__ float sh_fold[LANE_PARTS];
  __shared__ float sh_dev[LANES_WARPS];
  __shared__ bool sh_last;
  const int n = in.n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * LANES_WARPS + warp;
  if (i < n) {  // the whole warp or none of it
    V3 pos = ld3(in.pos, i, n);
    Q4 q = ld4(in.quat, i, n);
    V3 wh = world_halves(q, half_of(in.size, i, n));
    float travel_i = travel_of(in, i, p);
    float min_gap = F(1.0e9);
    bool near = false;
    for (int d0 = 0; d0 < in.d; d0 += 32) {
      const int d = d0 + lane;
      const int idx = d < in.d ? in.nb[d * n + i] : -1;
      if (idx < 0) continue;
      V3 pp = ld3(in.pos, idx, n);
      V3 pwh = world_halves(ld4(in.quat, idx, n), half_of(in.size, idx, n));
      float gap = max_nan(max_nan(fabsf(pp.x - pos.x) - (wh.x + pwh.x),
                                  fabsf(pp.y - pos.y) - (wh.y + pwh.y)),
                          fabsf(pp.z - pos.z) - (wh.z + pwh.z));
      min_gap = min_nan(min_gap, gap);
      float reach = (travel_i + travel_of(in, idx, p)) + p.reach_const;
      near = near || (gap - reach <= p.collision_margin);
    }
    for (int off = 16; off > 0; off >>= 1)
      min_gap = min_nan(min_gap, __shfl_xor_sync(FULL_MASK, min_gap, off));
    near = __any_sync(FULL_MASK, near);
    if (lane == 0) {
      V3 lv = ld3(in.lv, i, n);
      float speed_sq = lv.x * lv.x + lv.y * lv.y + lv.z * lv.z;
      bool dyn = in.inv_mass[i] > F(0.0);
      bool alive = dyn && (p.has_fall_freeze == F(0.0) || pos.y >= p.fall_freeze_y);
      float v2 = alive ? speed_sq : F(0.0);
      AnchorTerms a = anchor_terms(pos, q, ld3(in.anchor, i, n), ld4(in.anchor_q, i, n),
                                   in.radius[i], dyn);
      float mf = a.moved ? F(1.0) : F(0.0);
      RACE_DELAY();
      dv[i] = make_float4(a.disp.x, a.disp.y, a.disp.z, a.moved ? a.chord : F(-1.0));
      __threadfence();
      sh[0][warp] = min_gap;
      sh[1][warp] = v2;
      sh[2][warp] = near ? v2 : F(0.0);
      sh[3][warp] = a.moved ? sqrtf(a.disp2) + a.chord : F(0.0);
      sh[4][warp] = mf;
      sh[5][warp] = a.disp.x * mf;
      sh[6][warp] = a.disp.y * mf;
      sh[7][warp] = a.disp.z * mf;
    }
  } else if (lane == 0) {
    const float none[LANE_PARTS] = {F(1.0e9), 0, 0, 0, 0, 0, 0, 0};
    for (int k = 0; k < LANE_PARTS; ++k) sh[k][warp] = none[k];
  }
  __syncthreads();
  if (threadIdx.x < LANE_PARTS) {  // one thread a partial, bodies in order
    const int k = threadIdx.x;
    float v = fold_group(sh[k], part_op(k));
    RACE_DELAY();
    part[blockIdx.x * LANE_PARTS + k] = v;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    RACE_DELAY();
    sh_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!sh_last) return;
  // The last block: every block's partials and dv are visible (each fenced
  // before its ticket); read them from L2, past this SM's L1.
  __threadfence();
  if (warp < LANE_PARTS) {
    float v = fold_parts_warp(part, gridDim.x, warp, lane);
    if (lane == 0) sh_fold[warp] = v;
  }
  __syncthreads();
  float nmc = fmaxf(sh_fold[4], F(1.0));
  V3 t = v3(sh_fold[5] / nmc, sh_fold[6] / nmc, sh_fold[7] / nmc);
  float dev_mm = dev_mm_block(dv, n, t, sh_dev);
  if (threadIdx.x == 0) {
    out[0] = sh_fold[1];
    out[1] = sh_fold[2];
    out[2] = sh_fold[0];
    out[3] = dev_mm;
    out[4] = sh_fold[3];
    *ticket = 0u;
  }
}

extern "C" {

// ptrs: nb, pos, quat, size, radius, linvel, angvel, inv_mass, anchor,
// anchor_quat, out (5 floats), then scratch: the partials (LANE_PARTS floats
// per block of LANES_WARPS bodies), dv (4
// floats per body, 16-byte aligned) and the ticket (1 unsigned int, 0 before
// the launch and after it); each of them for ``batch`` worlds one after
// another.  Returns the CUDA error code of the launch.
int avbd_control_lanes(void** ptrs, const float* params, int n, int d, int batch,
                       void* stream) {
  CtrlIn in;
  in.nb = (const int*)ptrs[0];
  in.pos = (const float*)ptrs[1];
  in.quat = (const float*)ptrs[2];
  in.size = (const float*)ptrs[3];
  in.radius = (const float*)ptrs[4];
  in.lv = (const float*)ptrs[5];
  in.av = (const float*)ptrs[6];
  in.inv_mass = (const float*)ptrs[7];
  in.anchor = (const float*)ptrs[8];
  in.anchor_q = (const float*)ptrs[9];
  in.n = n;
  in.d = d;
  KParams p = *(const KParams*)params;
  const int blocks = (n + LANES_WARPS - 1) / LANES_WARPS;
  k_control_lanes<<<dim3(blocks, batch), LANES_WARPS * 32, 0, (cudaStream_t)stream>>>(
      in, p, (float*)ptrs[11], (float4*)ptrs[12], (unsigned int*)ptrs[13], (float*)ptrs[10]);
  return (int)cudaGetLastError();
}

int avbd_n_params() { return (int)(sizeof(KParams) / sizeof(float)); }

}  // extern "C"
