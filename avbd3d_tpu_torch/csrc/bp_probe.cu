// K7: the broadphase probe kernel.
//
// Replaces bp_probe_tpu / _make_kernel_probe
// (avbd3d_tpu/solver_tpu.py:177-225; math ops/broadphase.py:716-782): for
// every cached candidate slot the best of the six face-axis SAT separations
// at the current poses, reduced to min_sep (1e9 when no slot is valid), the
// count of valid slots, and the per-body near mask behind the refined
// stale-Hessian gate (solver.stale_lhs_ok).
//
// What bounds it on the H100: latency.  The (D, N) slot scan reads ~170 KB
// at Stress1000's widths (N = 1024, D = 24) and does ~300 float operations
// per valid slot, microseconds below a launch's own cost; what is left is
// each slot's dependent chain (two gathers, then the six axes).  Design: one
// launch.  A warp per body and a lane per candidate slot (lanes stride over
// the slots when D > 32), so a slot's chain is the only serial work and N =
// 1024 spreads over 128 blocks of 8 bodies.  Every lane computes the body's
// own axes and projections (a few dozen operations, cheaper than a shuffle
// of 12 floats); the warp folds best with fminf, counts valid slots with
// __popc(__ballot_sync) and takes near with __any_sync.  Each block writes
// its min and count; the last block to finish (a ticket taken after a
// __threadfence) folds every block's partials and resets the ticket to 0, so
// the three outputs come from this one kernel and no state outlives it.
// min, or and an integer sum do not depend on order, so the outputs equal the
// plain version's (ops/broadphase.bp_probe) bit for bit; every float
// expression repeats its statement order (avbd_common.cuh).  Poses are finite
// here (the step sanitizes them), so fmaxf/fminf and torch.maximum/minimum
// agree.  No float atomics.
#include "avbd_common.cuh"

#define PROBE_WARPS 8

// Projection radius of a box (axes ax, half extents h) onto nv:
// sum over k of h[k] * |ax[k] . nv|, folded left.
__device__ __forceinline__ float proj_radius(const V3 ax[3], V3 h, V3 nv) {
  return h.x * fabsf(vdot(ax[0], nv)) + h.y * fabsf(vdot(ax[1], nv))
         + h.z * fabsf(vdot(ax[2], nv));
}

// in: nb, pos, quat, size, radius, lv, av, n, d (the other CtrlIn fields are
// unused).  p.reach_const holds the probe's own constant, 4 * dt * dt * |g|.
// part_min / part_cnt: one entry per block; ticket: 0 at launch, 0 after.
__global__ void __launch_bounds__(PROBE_WARPS * 32)
k_probe(CtrlIn in, KParams p, unsigned char* near_out, float* part_min, int* part_cnt,
        unsigned int* ticket, float* min_sep, int* n_slots) {
  __shared__ float sh_min[PROBE_WARPS];
  __shared__ int sh_cnt[PROBE_WARPS];
  __shared__ bool sh_last;
  const int n = in.n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * PROBE_WARPS + warp;
  float mn = F(1.0e9);
  int cnt = 0;
  if (i < n) {  // the whole warp or none of it
    V3 pos = ld3(in.pos, i, n);
    V3 own_half = half_of(in.size, i, n);
    V3 own_ax[3];
    qaxes(ld4(in.quat, i, n), own_ax);
    float own_proj[3];
    for (int a = 0; a < 3; ++a) own_proj[a] = proj_radius(own_ax, own_half, own_ax[a]);
    float travel_i = travel_of(in, i, p);
    bool near = false;
    for (int d0 = 0; d0 < in.d; d0 += 32) {
      const int d = d0 + lane;
      const int idx = d < in.d ? in.nb[d * n + i] : -1;
      cnt += __popc(__ballot_sync(FULL_MASK, idx >= 0));
      if (idx < 0) continue;
      V3 delta = vsub(ld3(in.pos, idx, n), pos);
      V3 ph = half_of(in.size, idx, n);
      V3 par_ax[3];
      qaxes(ld4(in.quat, idx, n), par_ax);
      float best = F(-1.0e9);
      for (int a = 0; a < 3; ++a) {
        float sep = fabsf(vdot(delta, own_ax[a])) - own_proj[a]
                    - proj_radius(par_ax, ph, own_ax[a]);
        best = fmaxf(best, sep);
      }
      for (int a = 0; a < 3; ++a) {
        float sep = fabsf(vdot(delta, par_ax[a])) - proj_radius(own_ax, own_half, par_ax[a])
                    - proj_radius(par_ax, ph, par_ax[a]);
        best = fmaxf(best, sep);
      }
      mn = fminf(mn, best);
      float reach = (travel_i + travel_of(in, idx, p)) + p.reach_const;
      near = near || (best - reach <= p.collision_margin);
    }
    for (int off = 16; off > 0; off >>= 1) mn = fminf(mn, __shfl_xor_sync(FULL_MASK, mn, off));
    near = __any_sync(FULL_MASK, near);
    if (lane == 0) near_out[i] = near ? 1 : 0;
  }
  if (lane == 0) {
    sh_min[warp] = mn;
    sh_cnt[warp] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bm = sh_min[0];
    int bc = sh_cnt[0];
    for (int w = 1; w < PROBE_WARPS; ++w) {
      bm = fminf(bm, sh_min[w]);
      bc += sh_cnt[w];
    }
    RACE_DELAY();
    part_min[blockIdx.x] = bm;
    part_cnt[blockIdx.x] = bc;
    __threadfence();
    RACE_DELAY();
    sh_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!sh_last || warp != 0) return;
  // The last block: every other block's partials are visible (each fenced
  // before its ticket); read them from L2, past this SM's L1.
  __threadfence();
  float fm = F(1.0e9);
  int fc = 0;
  for (int b = lane; b < (int)gridDim.x; b += 32) {
    fm = fminf(fm, __ldcg(part_min + b));
    fc += __ldcg(part_cnt + b);
  }
  for (int off = 16; off > 0; off >>= 1) {
    fm = fminf(fm, __shfl_xor_sync(FULL_MASK, fm, off));
    fc += __shfl_xor_sync(FULL_MASK, fc, off);
  }
  if (lane == 0) {
    *min_sep = fm;
    *n_slots = fc;
    *ticket = 0u;
  }
}

extern "C" {

// ptrs: nb, pos, quat, size, radius, linvel, angvel, then the outputs min_sep
// (1 float), n_slots (1 int), near (n bytes, 0/1), then scratch: per-block
// min and count (ceil(n / PROBE_WARPS) floats and ints) and the ticket (1 unsigned int, 0 before the launch and after it).
// Returns the CUDA error code of the launch.
int avbd_bp_probe(void** ptrs, const float* params, int n, int d, void* stream) {
  CtrlIn in;
  in.nb = (const int*)ptrs[0];
  in.pos = (const float*)ptrs[1];
  in.quat = (const float*)ptrs[2];
  in.size = (const float*)ptrs[3];
  in.radius = (const float*)ptrs[4];
  in.lv = (const float*)ptrs[5];
  in.av = (const float*)ptrs[6];
  in.inv_mass = nullptr;
  in.anchor = nullptr;
  in.anchor_q = nullptr;
  in.n = n;
  in.d = d;
  KParams p = *(const KParams*)params;
  const int blocks = (n + PROBE_WARPS - 1) / PROBE_WARPS;
  k_probe<<<blocks, PROBE_WARPS * 32, 0, (cudaStream_t)stream>>>(
      in, p, (unsigned char*)ptrs[9], (float*)ptrs[10], (int*)ptrs[11],
      (unsigned int*)ptrs[12], (float*)ptrs[7], (int*)ptrs[8]);
  return (int)cudaGetLastError();
}

}  // extern "C"
