// K5 and K6: the grid tier's kernels (scenes above 2048 bodies).
//
// K5, avbd_collide_grid, replaces collide_and_init_grid / _make_kernel_a_grid
// (avbd3d_tpu/solver_tpu.py:1239-1394).  The TPU version blocks the collide
// over groups of bodies only to stay under a compiler ceiling; per body it
// computes what K1's collide half computes, so this entry point runs K1's
// own kernels (k_filter_cull, k_collide: one SAT, in step_kernel.cu) at any N
// and adds what the grid tier needs besides: the symmetric filter's keep
// mask (written by k_filter_cull when Work::keptmask is set), the
// once-per-pair mask (written by k_collide's lane that writes the slot's
// partner, when Work::once is set) and the dropped-manifold count
// (counters[1]).  Two kernels, one warp per body and a group of 4 lanes per
// cache slot (see there).
//
// K6, avbd_iterblock_grid, replaces _iterblock_grid_call /
// _make_kernel_iterblock_grid (solver_tpu.py:1397-1651): one launch of
// ``grid_residency`` solver iterations.  Semantics kept from the reference:
// every launch recomputes the geometry and rebuilds the Hessian from its
// start poses (nothing but poses, duals, penalties and stick latches
// carries between launches), and a slot whose partner lies in another
// logical block of ``blk`` bodies reads that partner's launch-start pose
// (Work::snap_pos / snap_quat) while same-block partners read the current
// one.  The two replicas of a cross-block pair then see different partner
// poses and their duals differ by design.
//
// What bounds them on the H100: as K1, latency and dependent arithmetic; the
// Stress4096 contact state (16 cache slots x 5120 bodies, ~15 MB) sits in
// the 50 MB L2.  Design of K6: the logical blocks of a launch are independent
// by construction (partners outside read the snapshot), so where a logical
// block fits one thread-block cluster (blk = 1024 bodies: 16 blocks of 64
// bodies x 16 slots) the launch is ONE kernel, K1's k_sweeps: each cluster
// copies its block's launch-start state into the working buffers, computes
// the geometry and runs the launch's iterations with the slot-parallel primal
// pass, a cluster barrier between the half-sweeps.  Where it does not
// (blk = 2048), the launch queues k_geom, then k_primal + k_dual per
// iteration.  solver_cuda.sweep_plan decides which, before the launch.
// Built with --fmad=false and without fast math, as K1, so each kernel equals
// its plain PyTorch version.
#include "step_kernel.cuh"

extern "C" {

// K5.  ptrs (in order):
//   0-11  old cache: other, count, feature, r_a, r_b, normal, stick, c0_n,
//         c0_t1, c0_t2, lam, penalty
//   12-14 nb, key, thr
//   15-18 pos, quat, size, inv_mass
//   19-30 new cache (same order as 0-11)
//   31    kept mask (D, N) float; 32 once mask (DC, N) bytes
//   33    scratch nbc (DC, N) ints; 34 counters (3 ints: kept, dropped, -)
// Returns the first non-zero CUDA error code, or 0.
int avbd_collide_grid(void** ptrs, const float* params, int n, int d, int dc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dc > d || n % 128 != 0) return (int)cudaErrorInvalidValue;
  KParams p = *(const KParams*)params;
  Dims dm{n, d, dc};
  Cache old, c;
  cache_from(ptrs, &old);
  cache_from(ptrs + 19, &c);
  Bodies b = {};
  b.pos = (const float*)ptrs[15];
  b.quat = (const float*)ptrs[16];
  b.size = (const float*)ptrs[17];
  b.inv_mass = (const float*)ptrs[18];
  Work w = {};
  w.keptmask = (float*)ptrs[31];
  w.once = (unsigned char*)ptrs[32];
  w.nbc = (int*)ptrs[33];
  w.counters = (int*)ptrs[34];
  cudaError_t err = cudaMemsetAsync(w.counters, 0, 3 * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_collide(dm, (const int*)ptrs[12], (const int*)ptrs[13], (const int*)ptrs[14], old, c, b, w,
                             p, st);
}

// K6.  ptrs (in order):
//   0-7   contacts: other, count, r_a, r_b, normal, c0_n, c0_t1, c0_t2
//   8-12  launch-start pos (3N), quat (4N), lam, penalty (12 DC N),
//         stick (4 DC N, 0/1 floats)
//   13-17 mass, inv_mass, friction, inertia, inv_inertia
//   18-19 inertial target ip (3N), iq (4N)
//   20-24 outputs pos, quat, lam, penalty, stick
//   25-26 scratch geom (36 DC N), mat (24 N)
// ``flags``: (do_dual, rebuild, ramp) per iteration; ``alphas``: alpha per
// iteration.  ``blk``: bodies per logical block.  ``plan``: the shape's
// sweep plan, PLAN_INTS ints in SweepPlan order.
// Returns the first non-zero CUDA error code, or 0.
int avbd_iterblock_grid(void** ptrs, const float* params, int n, int dc, int blk, int n_iters,
                        const int* flags, const float* alphas, const int* plan, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n % 128 != 0 || blk <= 0 || n % blk != 0 || n_iters < 0) return (int)cudaErrorInvalidValue;
  KParams p = *(const KParams*)params;
  const SweepPlan pl = plan_from(plan);
  Dims dm{n, dc, dc};
  Cache c = {};
  c.other = (int*)ptrs[0];
  c.count = (int*)ptrs[1];
  c.r_a = (float*)ptrs[2];
  c.r_b = (float*)ptrs[3];
  c.normal = (float*)ptrs[4];
  c.c0_n = (float*)ptrs[5];
  c.c0_t1 = (float*)ptrs[6];
  c.c0_t2 = (float*)ptrs[7];
  c.lam = (float*)ptrs[22];
  c.pen = (float*)ptrs[23];
  c.stick = (float*)ptrs[24];
  Bodies b = {};
  b.mass = (const float*)ptrs[13];
  b.inv_mass = (const float*)ptrs[14];
  b.friction = (const float*)ptrs[15];
  b.inertia = (const float*)ptrs[16];
  b.inv_inertia = (const float*)ptrs[17];
  Work w = {};
  w.ip = (float*)ptrs[18];
  w.iq = (float*)ptrs[19];
  w.pos = (float*)ptrs[20];
  w.quat = (float*)ptrs[21];
  w.geom = (float*)ptrs[25];
  w.mat = (float*)ptrs[26];
  w.snap_pos = (const float*)ptrs[8];
  w.snap_quat = (const float*)ptrs[9];
  w.blk = blk;
  if (pl.cluster > 0) {
    // One launch: the copies, the geometry and every iteration.
    if (n_iters > MAX_RESIDENT_ITERS) return (int)cudaErrorInvalidValue;
    IterPlan ip = {};   // the caller's flags, not a step's (iter_plan)
    ip.n = n_iters;
    for (int j = 0; j < n_iters; ++j) {
      ip.alpha[j] = alphas[j];
      ip.do_dual[j] = flags[3 * j] != 0;
      ip.rebuild[j] = flags[3 * j + 1] != 0 || j == 0;
      ip.ramp[j] = flags[3 * j + 2] != 0;
    }
    Carry carry;
    carry.pos = (const float*)ptrs[8];
    carry.quat = (const float*)ptrs[9];
    carry.lam = (const float*)ptrs[10];
    carry.pen = (const float*)ptrs[11];
    carry.stick = (const float*)ptrs[12];
    return (int)launch_sweeps(pl, dm, c, b, w, p, ip, 1, carry, st);
  }
  const size_t f4 = sizeof(float), slots = (size_t)dc * n;
  const size_t sizes[5] = {3 * n * f4, 4 * n * f4, 12 * slots * f4, 12 * slots * f4, 4 * slots * f4};
  for (int q = 0; q < 5; ++q) {
    cudaError_t err = cudaMemcpyAsync(ptrs[20 + q], ptrs[8 + q], sizes[q], cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return (int)err;
  }
  const int nb_slot = blocks_for(dc * n);
  k_geom<<<nb_slot, BLOCK, 0, st>>>(dm, c, w);
  for (int j = 0; j < n_iters; ++j) {
    const int* f = flags + 3 * j;
    cudaError_t err = launch_primal(pl, dm, c, b, w, p, f[1] || j == 0, alphas[j], st);
    if (err != cudaSuccess) return (int)err;
    k_dual<<<nb_slot, BLOCK, 0, st>>>(dm, c, b, w, p, f[0], f[2], alphas[j]);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
