// The contact step's device operands and kernels, shared by the fused step
// (step_kernel.cu, K1) and the grid tier (grid_kernels.cu, K5 and K6).  The
// kernels are defined in step_kernel.cu and launched from both files.
#pragma once

#include "avbd_common.cuh"

#define BLOCK 128
#define NEG_BIG F(-3.0e38)

struct Cache {
  int* other;       // (DC, N)
  int* count;       // (DC, N)
  int* feature;     // (4, DC, N)
  float* r_a;       // (4, 3, DC, N)
  float* r_b;       // (4, 3, DC, N)
  float* normal;    // (3, DC, N)
  float* stick;     // (4, DC, N) 0/1
  const unsigned char* stick_b;  // (4, DC, N) the old cache's latches as bools
                                 // (K1), read in place of ``stick``; or null
  float* c0_n;      // (4, DC, N)
  float* c0_t1;
  float* c0_t2;
  float* lam;       // (12, DC, N)
  float* pen;       // (12, DC, N)
};

struct Bodies {
  const float* pos;
  const float* quat;
  const float* size;
  const float* radius;
  const float* lv;
  const float* av;
  const float* plv;
  const float* mass;
  const float* inv_mass;
  const float* friction;
  const float* inertia;
  const float* inv_inertia;
};

struct Work {
  float* pos;       // (3, N) working / output pose
  float* quat;      // (4, N)
  float* lv_out;    // (3, N)
  float* av_out;
  float* plv_out;
  float* pav_out;
  float* ip;        // (3, N) inertial target
  float* iq;        // (4, N)
  float* geom;      // (36, DC, N): rw_a(4x3), rw_b(4x3), sep(4), slip1(4), slip2(4)
  float* mat;       // (24, N) carried 6x6 Hessian blocks + gyro
  int* nbc;         // (DC, N) culled neighbors
  int* counters;    // [kept, dropped, sanitized]
  float* diag;      // (8, 128)
  unsigned char* stick_out;  // (4, DC, N) the new cache's latches as bools (K1), or null
  const int* cand;  // () directed candidates at the refresh (K1: diag row 1); null in K4
  float* keptmask;  // (D, N) symmetric-filter keep mask, or null
  unsigned char* once;  // (DC, N) once-per-pair mask of the new cache, or null
  // Partner poses: a slot whose partner lies in the same logical block of
  // ``blk`` bodies reads ``pos``/``quat``; any other partner reads the
  // launch-start poses ``snap_pos``/``snap_quat`` (the grid tier's
  // cross-block lag).  K1 runs one block: blk = N.
  const float* snap_pos;   // (3, N)
  const float* snap_quat;  // (4, N)
  int blk;
};

struct Dims {
  int n, d, dc;
};

// The sweep plan of a shape (solver_cuda.sweep_plan computes it; the C side
// takes its numbers as they are).  A thread block owns ``tile`` bodies and
// runs ``threads`` = tile * lanes threads; thread (lane, body) takes the
// cache slots lane, lane + lanes, ... (``spt`` of them at most).  ``smem``:
// dynamic shared memory of the block in bytes.  ``cluster`` > 0: the sweeps
// of a logical block run in one launch of thread-block clusters of that
// many blocks (tile * cluster bodies = one logical block).  ``grid`` 1: the
// sweeps of the world run in one cooperative launch, a grid barrier between
// colour sub-passes (worlds with joint or spring rows).  Both 0: one launch
// per half-sweep (contact-only worlds).
struct SweepPlan {
  int tile, threads, spt, smem, cluster, grid;
};

#define PLAN_INTS 6
static inline SweepPlan plan_from(const int* v) { return SweepPlan{v[0], v[1], v[2], v[3], v[4], v[5]}; }

// The iterations of one cluster-resident launch.
#define MAX_RESIDENT_ITERS 64
struct IterPlan {
  int n;
  float alpha[MAX_RESIDENT_ITERS];
  unsigned char do_dual[MAX_RESIDENT_ITERS], rebuild[MAX_RESIDENT_ITERS], ramp[MAX_RESIDENT_ITERS];
};

// Launch-start state a cluster-resident launch copies into its working
// buffers before its first sweep (the grid tier); all null: nothing to copy.
struct Carry {
  const float* pos;    // (3, N)
  const float* quat;   // (4, N)
  const float* lam;    // (12, DC, N)
  const float* pen;    // (12, DC, N)
  const float* stick;  // (4, DC, N)
};

// The collide half of a step (K1, K3, K5): k_filter_cull (one warp per
// body) then k_collide (a group of COLLIDE_LANES lanes per cache slot); with
// w.keptmask / w.once set it also writes the keep mask and the once-per-pair
// mask.  Returns the launches' CUDA error.
cudaError_t launch_collide(Dims dm, const int* nb, const int* key, const int* thr, Cache old, Cache c, Bodies b,
                           Work w, KParams p, cudaStream_t st);
__global__ void __launch_bounds__(BLOCK) k_geom(Dims dm, Cache c, Work w);
__global__ void __launch_bounds__(BLOCK) k_dual(Dims dm, Cache c, Bodies b, Work w, KParams p, int do_dual,
                                                int ramp, float alpha_cur);

// Host launchers of the tiled sweep kernels (defined in step_kernel.cu): the
// primal pass of one sweep, and the whole sweep loop of ``ip`` in one
// cluster launch (with the geometry at the start poses first when
// ``with_geom``).  Both return the launch's CUDA error.
cudaError_t launch_primal(const SweepPlan& pl, Dims dm, Cache c, Bodies b, Work w, KParams p, int rebuild,
                          float alpha_cur, cudaStream_t st);
cudaError_t launch_sweeps(const SweepPlan& pl, Dims dm, Cache c, Bodies b, Work w, KParams p, const IterPlan& ip,
                          int with_geom, Carry carry, cudaStream_t st);

static inline int blocks_for(int threads) { return (threads + BLOCK - 1) / BLOCK; }

// The 12 cache leaves from a pointer list in CACHE_FIELDS order.
static inline void cache_from(void** a, Cache* c) {
  c->other = (int*)a[0];
  c->count = (int*)a[1];
  c->feature = (int*)a[2];
  c->r_a = (float*)a[3];
  c->r_b = (float*)a[4];
  c->normal = (float*)a[5];
  c->stick = (float*)a[6];
  c->stick_b = nullptr;
  c->c0_n = (float*)a[7];
  c->c0_t1 = (float*)a[8];
  c->c0_t2 = (float*)a[9];
  c->lam = (float*)a[10];
  c->pen = (float*)a[11];
}
