// K5 and K6: the grid tier's kernels (scenes above 2048 bodies).
//
// K5, avbd_collide_grid, replaces collide_and_init_grid / _make_kernel_a_grid
// (avbd3d_tpu/solver_tpu.py:1239-1394).  The TPU version blocks the collide
// over groups of bodies only to stay under a compiler ceiling; per body it
// computes what K1's collide half computes, so this entry point runs K1's
// own kernels (k_filter_cull, k_collide: one SAT, in step_kernel.cu) at any N
// and adds what the grid tier needs besides: the symmetric filter's keep
// mask (written by k_filter_cull when Work::keptmask is set), the
// once-per-pair mask (k_once) and the dropped-manifold count (counters[1]).
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
// the 50 MB L2.  Design: K1's barrier scheme, one launch per phase and per
// half-sweep queued from one host call (k_geom, then k_primal + k_dual per
// iteration: 9 launches for 4 iterations).  Built with --fmad=false and
// without fast math, as K1, so each kernel equals its plain PyTorch version.
#include "step_kernel.cuh"

// Once-per-pair counting mask (ops/replicated.once_mask), one thread per
// cache slot.
__global__ void __launch_bounds__(BLOCK) k_once(Dims dm, const int* other, const float* inv_mass,
                                                unsigned char* once) {
  int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= dm.dc * dm.n) return;
  int i = gid % dm.n;
  int o = other[gid];
  bool valid = o >= 0;
  int idx = valid ? o : 0;
  bool other_dyn = (inv_mass[idx] > F(0.0) ? F(1.0) : F(0.0)) > F(0.5);
  once[gid] = (valid && ((i < idx) || !other_dyn)) ? 1 : 0;
}

static void cache_from(void** a, Cache* c) {
  c->other = (int*)a[0];
  c->count = (int*)a[1];
  c->feature = (int*)a[2];
  c->r_a = (float*)a[3];
  c->r_b = (float*)a[4];
  c->normal = (float*)a[5];
  c->stick = (float*)a[6];
  c->c0_n = (float*)a[7];
  c->c0_t1 = (float*)a[8];
  c->c0_t2 = (float*)a[9];
  c->lam = (float*)a[10];
  c->pen = (float*)a[11];
}

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
  w.nbc = (int*)ptrs[33];
  w.counters = (int*)ptrs[34];
  cudaError_t err = cudaMemsetAsync(w.counters, 0, 3 * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  k_filter_cull<<<blocks_for(n), BLOCK, 0, st>>>(dm, (const int*)ptrs[12], (const int*)ptrs[13],
                                                 (const int*)ptrs[14], b, w, p);
  k_collide<<<blocks_for(dc * n), BLOCK, 0, st>>>(dm, old, c, b, w, p);
  k_once<<<blocks_for(dc * n), BLOCK, 0, st>>>(dm, c.other, b.inv_mass, (unsigned char*)ptrs[32]);
  return (int)cudaGetLastError();
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
// iteration.  ``blk``: bodies per logical block.
// Returns the first non-zero CUDA error code, or 0.
int avbd_iterblock_grid(void** ptrs, const float* params, int n, int dc, int blk, int n_iters,
                        const int* flags, const float* alphas, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n % 128 != 0 || blk <= 0 || n % blk != 0) return (int)cudaErrorInvalidValue;
  KParams p = *(const KParams*)params;
  Dims dm{n, dc, dc};
  const size_t f4 = sizeof(float), slots = (size_t)dc * n;
  const size_t sizes[5] = {3 * n * f4, 4 * n * f4, 12 * slots * f4, 12 * slots * f4, 4 * slots * f4};
  for (int q = 0; q < 5; ++q) {
    cudaError_t err = cudaMemcpyAsync(ptrs[20 + q], ptrs[8 + q], sizes[q], cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return (int)err;
  }
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
  const int nb_body = blocks_for(n), nb_slot = blocks_for(dc * n);
  k_geom<<<nb_slot, BLOCK, 0, st>>>(dm, c, w);
  for (int j = 0; j < n_iters; ++j) {
    const int* f = flags + 3 * j;
    k_primal<<<nb_body, BLOCK, 0, st>>>(dm, c, b, w, p, f[1] || j == 0, alphas[j]);
    k_dual<<<nb_slot, BLOCK, 0, st>>>(dm, c, b, w, p, f[0], f[2], alphas[j]);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
