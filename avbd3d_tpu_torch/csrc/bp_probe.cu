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
// per valid slot, microseconds below a launch's own cost.  Design: one thread
// per body (own axes and own projections once, then its D slots, skipping
// empty ones: every use of a slot's value is masked by its validity), 128
// bodies a block so N / 128 blocks spread over the SMs (the TPU kernel is one
// unblocked program and stops at G = 16; this one takes any N that is a
// multiple of 128), a shared-memory tree for the block's min and count, and a
// one-warp second kernel that folds the per-block partials.  min, or and an
// integer sum do not depend on order, so the outputs equal the plain
// version's (ops/broadphase.bp_probe) bit for bit; every float expression
// repeats its statement order (avbd_common.cuh).  Poses are finite here (the
// step sanitizes them), so fmaxf/fminf and torch.maximum/minimum agree.
#include "avbd_common.cuh"

#define PROBE_THREADS 128

// Projection radius of a box (axes ax, half extents h) onto nv:
// sum over k of h[k] * |ax[k] . nv|, folded left.
__device__ __forceinline__ float proj_radius(const V3 ax[3], V3 h, V3 nv) {
  return h.x * fabsf(vdot(ax[0], nv)) + h.y * fabsf(vdot(ax[1], nv))
         + h.z * fabsf(vdot(ax[2], nv));
}

// in: nb, pos, quat, size, radius, lv, av, n, d (the other CtrlIn fields are
// unused).  p.reach_const holds the probe's own constant, 4 * dt * dt * |g|.
__global__ void __launch_bounds__(PROBE_THREADS)
k_probe(CtrlIn in, KParams p, unsigned char* near_out, float* part_min, int* part_cnt) {
  __shared__ float sh_min[PROBE_THREADS];
  __shared__ int sh_cnt[PROBE_THREADS];
  const int n = in.n;
  const int tid = threadIdx.x;
  const int i = blockIdx.x * PROBE_THREADS + tid;
  float mn = F(1.0e9);
  int cnt = 0;
  if (i < n) {
    V3 pos = ld3(in.pos, i, n);
    V3 own_half = half_of(in.size, i, n);
    V3 own_ax[3];
    qaxes(ld4(in.quat, i, n), own_ax);
    float own_proj[3];
    for (int a = 0; a < 3; ++a) own_proj[a] = proj_radius(own_ax, own_half, own_ax[a]);
    float travel_i = travel_of(in, i, p);
    bool near = false;
    for (int d = 0; d < in.d; ++d) {
      int idx = in.nb[d * n + i];
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
      cnt += 1;
      float reach = (travel_i + travel_of(in, idx, p)) + p.reach_const;
      near = near || (best - reach <= p.collision_margin);
    }
    near_out[i] = near ? 1 : 0;
  }
  sh_min[tid] = mn;
  sh_cnt[tid] = cnt;
  __syncthreads();
  for (int s = PROBE_THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) {
      sh_min[tid] = fminf(sh_min[tid], sh_min[tid + s]);
      sh_cnt[tid] += sh_cnt[tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
    part_min[blockIdx.x] = sh_min[0];
    part_cnt[blockIdx.x] = sh_cnt[0];
  }
}

// One warp folds the per-block partials into min_sep and n_slots.
__global__ void __launch_bounds__(32)
k_probe_finish(const float* part_min, const int* part_cnt, int blocks, float* min_sep,
               int* n_slots) {
  float mn = F(1.0e9);
  int cnt = 0;
  for (int b = threadIdx.x; b < blocks; b += 32) {
    mn = fminf(mn, part_min[b]);
    cnt += part_cnt[b];
  }
  for (int off = 16; off > 0; off >>= 1) {
    mn = fminf(mn, __shfl_down_sync(0xffffffffu, mn, off));
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  }
  if (threadIdx.x == 0) {
    *min_sep = mn;
    *n_slots = cnt;
  }
}

extern "C" {

// ptrs: nb, pos, quat, size, radius, linvel, angvel, then the outputs min_sep
// (1 float), n_slots (1 int), near (n bytes, 0/1), then scratch: per-block
// min (n / 128 floats) and count (n / 128 ints).  Returns the CUDA error code
// of the launches.
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
  const int blocks = (n + PROBE_THREADS - 1) / PROBE_THREADS;
  float* part_min = (float*)ptrs[10];
  int* part_cnt = (int*)ptrs[11];
  cudaStream_t s = (cudaStream_t)stream;
  k_probe<<<blocks, PROBE_THREADS, 0, s>>>(in, p, (unsigned char*)ptrs[9], part_min, part_cnt);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  k_probe_finish<<<1, 32, 0, s>>>(part_min, part_cnt, blocks, (float*)ptrs[7], (int*)ptrs[8]);
  return (int)cudaGetLastError();
}

}  // extern "C"
