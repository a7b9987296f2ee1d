// K2: the control-lanes kernel.
//
// Replaces control_lanes_tpu / _make_kernel_control
// (avbd3d_tpu/solver_tpu.py:235-273; math ops/broadphase.py:785-851): the five
// step-control scalars (diagnostics lanes 11-15) on the current state, run on
// every contact-free (ballistic) step.
//
// What bounds it on the H100: nothing but latency.  The work is two
// reductions over N <= 2048 bodies and a (24, N) slot scan (~100 KB read), so
// a single launch costs a few microseconds however it is written.  Design: one
// block of 1024 threads striding over the bodies, tree reductions in shared
// memory (deterministic order), no atomics and no second launch for the mean.
#include "avbd_common.cuh"

__global__ void __launch_bounds__(CTRL_THREADS) k_control(CtrlIn in, KParams p, float* out) {
  __shared__ float sh[8 * CTRL_THREADS];
  control_lanes_block(in, p, out, sh);
}

extern "C" {

// ptrs: nb, pos, quat, size, radius, linvel, angvel, inv_mass, anchor,
// anchor_quat, out (5 floats).  Returns the CUDA error code of the launch.
int avbd_control_lanes(void** ptrs, const float* params, int n, int d, void* stream) {
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
  k_control<<<1, CTRL_THREADS, 0, (cudaStream_t)stream>>>(in, p, (float*)ptrs[10]);
  return (int)cudaGetLastError();
}

int avbd_n_params() { return (int)(sizeof(KParams) / sizeof(float)); }

}  // extern "C"
