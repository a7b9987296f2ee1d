// The fused path's stages around K1 and K2 on the card: the step's gates
// (k_step_gates) and the whole ballistic step but its control lanes
// (k_ballistic_step), one launch each.
//
// Neither replaces a Pallas kernel: the reference runs these stages as XLA
// inside its jitted step (avbd3d_tpu/solver.py:325-333 the fall-freeze;
// solver.py:418-447 the ballistic step, predict and finalize around its
// control lanes).  Their plain versions are the port's torch code
// (solver.step_gates_plain: solver.freeze_fallen and the control vector
// of read_control; solver._ballistic_body: solver.predict and
// solver.finalize), ~250 launches of small torch operations a ballistic
// step.
//
// Every float expression repeats the plain version's statements in their
// order (the shared pieces in avbd_common.cuh: freeze_body, the
// prediction's and the finalize velocities' halves, QUAT_MSQ / VNORM3 /
// VNORM3_XZY and atomic_fold, as grid_stages.cu runs them), and the library
// is built with --fmad=false and IEEE division and square root, so frozen
// fields, poses, velocities and lanes are the plain version's bits.  The
// ballistic finalize's rows come out of predict's torch.where, as the grid
// finalize's come out of its pose sanitize: the linear velocities
// component-major (VNORM3), the angular ones contiguous rows of quat_mul's
// torch.stack (VNORM3_XZY); phase 21 of chip_smoke.py holds the speed lanes
// to that order bit for bit.
//
// What bounds them on the H100: launch latency.  Their bytes at N = 1024,
// DC = 12 are ~50 KB (gates) and 0.26-0.45 MB (the ballistic step: the
// bodies' fields, every slot's count and partner, and the normal duals of
// the live contacts, none to all of the (4, 12, N)), 0.02-0.14 us at
// 3.35 TB/s, far below a launch's own few microseconds.
//
// k_step_gates, a thread a float of the frozen fields (7 planes of N): the
// fall-freeze when it is on (linvel, angvel and inv_mass of the frozen
// bodies written into new buffers, so a world the caller holds keeps its
// own), and a last block whose threads 0-17 pack the step's control
// vector: diagnostics lanes 0-15, bp.slack and float(bp.dropped), the
// buffer whose copy to the host is the step's one read.  No fold: nothing
// crosses threads.  Its time is a launch and one memory round trip, so a
// thread's loads (its body's inv_mass and pos.y and its one float) are
// all issued before its one store, no thread carries more than one float
// of a body, and the pack, whose loads held back the stores of the threads
// that shared them, runs on a block of its own (a thread a body that
// packed the vector after its body's stores took 1.72 us on the card,
// PERF.md section 6).  k_launch_floor is its floor at its grid and block:
// empty, one load and one store a thread, or k_step_gates' own three loads
// before its store, timed beside k_step_gates.
//
// k_ballistic_step, over a grid sized to the card (avbd_ballistic_step: a
// block for each 256 slots, at most two blocks an SM; a thread a (slot,
// body) with a thread's body chain and its slot in series, then a last
// block walking every block's partials, took 7.89 us on the card at
// Stress1000, PERF.md section 6): eight slot warps a block take the slots'
// maxima with the finalize's zero separations (lane 0: -0 where a slot is
// live, +0 elsewhere; lane 1: the slop; lane 4: |lambda_n|); beside them a
// linear and an angular warp a block take 32 bodies each in turn, a lane
// the linear half of a body's prediction and then its linear finalize at
// the inertial position (pose, velocity, previous velocity, the dynamic
// count), or the angular halves at the inertial quaternion, each adding
// the rows it sanitizes.  The lanes by atomic_fold: lanes 0-10 (5, 6, 9 and
// 10 are 0: no pair is counted, the overflows are 0) and lanes 11-15 at
// CONTROL_RESET, which K2 then overwrites.  Lane 0 folds keys that order -0
// below +0, and every body lane holds +0, so it is +0.
#include "avbd_common.cuh"

// ---------------------------------------------------------------------------
// k_step_gates
// ---------------------------------------------------------------------------

#define CONTROL_FLOATS 18  // diagnostics lanes 0-15, slack, dropped
#define GATES_PLANES 7     // the frozen fields' planes: linvel x, y, z, angvel x, y, z, inv_mass
#ifdef AVBD_GATES_THREADS  // another block size, for comparisons only (kernels.build's defines)
#define GATES_THREADS AVBD_GATES_THREADS
#else
#define GATES_THREADS 128
#endif

struct StepGatesArgs {
  const float* pos;       // (3, N)
  const float* lv;        // (3, N)
  const float* av;        // (3, N)
  const float* inv_mass;  // (N)
  const float* diag;      // (16) the world's diagnostics
  const float* slack;     // () bp.slack
  const int* dropped;     // () bp.dropped
  float* lv_out;          // (3, N) frozen linvel, angvel, inv_mass; null: no fall-freeze
  float* av_out;
  float* im_out;
  float* out;             // (18) the control vector
  int n;
  float freeze_y;
};

// Blocks 0 .. B - 2 (only with the fall-freeze on), thread t: plane c =
// t / N of body i = t mod N, the fall-freeze's test (frozen) and zeroing
// for that one float (torch.where(frozen, 0.0, x)), its three loads through
// the read-only path before its store.  The last block, threads 0-17: the
// control vector, on a block of its own so that no body's store waits
// behind its loads.
__global__ void k_step_gates(StepGatesArgs a) {
  const int n = a.n;
  if (blockIdx.x == gridDim.x - 1) {
    // read_control: cat([diagnostics, slack.to(float32), dropped.to(float32)])
    const int u = threadIdx.x;
    if (u < 16) a.out[u] = a.diag[u];
    else if (u == 16) a.out[16] = *a.slack;
    else if (u == 17) a.out[17] = (float)*a.dropped;
    return;
  }
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < GATES_PLANES * n) {
    const int c = t / n, i = t - c * n;
    const float im = __ldg(a.inv_mass + i), py = __ldg(a.pos + n + i);
    const float* src = c < 3 ? a.lv + c * n : (c < 6 ? a.av + (c - 3) * n : a.inv_mass);
    const float x = __ldg(src + i);
    float* dst = c < 3 ? a.lv_out + c * n : (c < 6 ? a.av_out + (c - 3) * n : a.im_out);
    dst[i] = frozen(im, py, a.freeze_y) ? F(0.0) : x;
  }
}

// The launch floor at k_step_gates' grid and block, by ``loads``: 0, empty;
// 1, thread t < 7N copies src[t] to dst[t] (a load and a store); 3,
// k_step_gates' access to the bodies without its control vector: thread t
// loads inv_mass[i] and pos.y[i] of its body i = t mod N and src[t], all
// before its one store (each load through the read-only path, as
// k_step_gates' are).
__global__ void k_launch_floor(const float* src, const float* inv_mass, const float* pos,
                               float* dst, int n, int loads, float freeze_y) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (loads == 0 || t >= GATES_PLANES * n) return;
  if (loads == 1) {
    dst[t] = __ldg(src + t);
    return;
  }
  const int i = t % n;
  const float im = __ldg(inv_mass + i), py = __ldg(pos + n + i), x = __ldg(src + t);
  dst[t] = frozen(im, py, freeze_y) ? F(0.0) : x;
}

// ---------------------------------------------------------------------------
// k_ballistic_step
// ---------------------------------------------------------------------------

#define BAL_F 5  // max lanes: penetration, violation, linear speed, angular speed, normal dual
#define BAL_I 2  // counts: dynamic bodies, sanitized rows
#define BAL_SLOT_WARPS 8  // warps a block for the slots
#define BAL_BODY_WARPS 2  // a linear and an angular warp a block for the bodies
#define BAL_WARPS (BAL_SLOT_WARPS + BAL_BODY_WARPS)
#define BAL_THREADS (32 * BAL_WARPS)

struct BallisticArgs {
  const float* pos;       // (3, N) the step's start poses
  const float* quat;      // (4, N)
  const float* lv;        // (3, N)
  const float* av;        // (3, N)
  const float* prev_lv;   // (3, N)
  const float* prev_av;   // (3, N)
  const float* inv_mass;  // (N)
  const int* count;       // (DC, N) the contact cache as it is
  const int* other;       // (DC, N)
  const float* lam;       // (12, DC, N)
  float* pos_out;         // (3, N) the inertial target
  float* quat_out;        // (4, N)
  float* lv_out;          // (3, N) finalized velocities
  float* av_out;
  float* prev_lv_out;     // (3, N) the prediction's velocities (dynamic bodies)
  float* prev_av_out;
  float* diag;            // (16)
  unsigned int* fold;     // BAL_F + BAL_I words, then the ticket: 0 before and after a launch
  int n;
  int dc;
};

// Slot thread t of the grid (the slot warps; stride: all of them) takes
// slots t, t + stride, ...: the maxima at the finalize's zero separations.
// Body warp 2c + h of the grid (c = b + gridDim.x r for block b): bodies
// 32 c .. 32 c + 31, a lane a body, the linear half (h = 0: the prediction's
// linear half, then finalize_linear at the inertial position; the dynamic
// count) or the angular half (h = 1: the prediction's angular half, then
// finalize_angular at the inertial quaternion) (tests/test_torch_port.py
// models these loops).  The 5 maxima and 2 counts by atomic_fold.
__global__ void __launch_bounds__(BAL_THREADS) k_ballistic_step(BallisticArgs a, KParams p) {
  __shared__ unsigned int shk[BAL_F + BAL_I][BAL_WARPS];
  const int n = a.n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float fv[BAL_F] = {F(0.0), F(0.0), F(0.0), F(0.0), F(0.0)};
  int iv[BAL_I] = {0, 0};
  if (warp < BAL_SLOT_WARPS) {
    const int slots = a.dc * n;
    const size_t plane = (size_t)slots;
    const int stride = gridDim.x * BAL_SLOT_WARPS * 32;
    const float sep = F(0.0);
    for (int t = blockIdx.x * BAL_SLOT_WARPS * 32 + threadIdx.x; t < slots; t += stride) {
      const bool valid = a.other[t] >= 0;
      const int cnt = a.count[t];
      for (int s = 0; s < 4; ++s) {
        const bool ok = s < cnt && valid;
        fv[0] = max_nan(fv[0], ok ? -sep : F(0.0));
        fv[1] = max_nan(fv[1], ok ? p.penetration_slop - sep : F(0.0));
        fv[4] = max_nan(fv[4], ok ? fabsf(a.lam[3 * s * plane + t]) : F(0.0));
      }
    }
  } else {
    const bool angular = warp - BAL_SLOT_WARPS == 1;
    for (int c = blockIdx.x; 32 * c < n; c += gridDim.x) {
      const int i = 32 * c + lane;
      if (i >= n) break;
      const bool dyn = a.inv_mass[i] > F(0.0);
      const float dynf = dyn ? F(1.0) : F(0.0);
      int san = 0;
      if (!angular) {
        const V3 pos0 = ld3(a.pos, i, n), lv0 = ld3(a.lv, i, n), plv = ld3(a.prev_lv, i, n);
        const PredLinear r = predict_linear(pos0, lv0, plv, dyn, p, &san);
        const V3 nl = finalize_linear(r.ip, pos0, lv0, dyn, p, &san);
        fv[2] = max_nan(fv[2], VNORM3(nl) * dynf);
        iv[0] += dyn ? 1 : 0;
        st3(a.pos_out, i, n, r.ip);
        st3(a.lv_out, i, n, nl);
        st3(a.prev_lv_out, i, n, dyn ? r.lv : plv);
      } else {
        const Q4 q0 = ld4(a.quat, i, n);
        const V3 av0 = ld3(a.av, i, n), pav = ld3(a.prev_av, i, n);
        const PredAngular r = predict_angular(q0, av0, dyn, p, &san);
        const V3 na = finalize_angular(r.iq, q0, av0, dyn, p, &san);
        fv[3] = max_nan(fv[3], VNORM3_XZY(na) * dynf);
        st4(a.quat_out, i, n, r.iq);
        st3(a.av_out, i, n, na);
        st3(a.prev_av_out, i, n, dyn ? r.av : pav);
      }
      iv[1] += san;
    }
  }
  unsigned int q[BAL_F + BAL_I];
#pragma unroll
  for (int k = 0; k < BAL_F; ++k) q[k] = max_key(fv[k]);
#pragma unroll
  for (int k = 0; k < BAL_I; ++k) q[BAL_F + k] = (unsigned int)iv[k];
  unsigned int w;
  if (!atomic_fold<BAL_F>(q, shk, a.fold, &w)) return;
  // Warp 0 of the last block: lane k writes lane k of the diagnostics.
  const int dyn_count = (int)__shfl_sync(FULL_MASK, w, BAL_F);
  const int san_count = (int)__shfl_sync(FULL_MASK, w, BAL_F + 1);
  float v;
  if (lane < BAL_F) v = max_of_key(w);
  else if (lane == 7) v = (float)dyn_count;
  else if (lane == 8) v = (float)san_count;
  else if (lane < 11) v = F(0.0);  // 5, 6: no slot is counted (once all False); 9, 10: overflows 0
  else v = lane == 13 ? F(0.0) : F(1.0e9);  // state.CONTROL_RESET
  if (lane < 16) a.diag[lane] = v;
}

extern "C" {

// k_step_gates' grid: a thread a float of the frozen fields (none without
// the fall-freeze), then the control vector's block.
static_assert(CONTROL_FLOATS <= GATES_THREADS, "the control vector takes one block");
static int gates_blocks(int n, bool freeze) {
  return (freeze ? (GATES_PLANES * n + GATES_THREADS - 1) / GATES_THREADS : 0) + 1;
}

// ptrs: pos, linvel, angvel, inv_mass, diagnostics (16 floats), slack (1
// float), dropped (1 int), then the frozen linvel, angvel, inv_mass (null
// each without the fall-freeze), out (CONTROL_FLOATS floats).
int avbd_step_gates(void** ptrs, int n, float freeze_y, void* stream) {
  StepGatesArgs a;
  a.pos = (const float*)ptrs[0];
  a.lv = (const float*)ptrs[1];
  a.av = (const float*)ptrs[2];
  a.inv_mass = (const float*)ptrs[3];
  a.diag = (const float*)ptrs[4];
  a.slack = (const float*)ptrs[5];
  a.dropped = (const int*)ptrs[6];
  a.lv_out = (float*)ptrs[7];
  a.av_out = (float*)ptrs[8];
  a.im_out = (float*)ptrs[9];
  a.out = (float*)ptrs[10];
  a.n = n;
  a.freeze_y = freeze_y;
  k_step_gates<<<gates_blocks(n, a.lv_out != nullptr), GATES_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// ptrs: src (7 x N floats), inv_mass (N), pos (3 x N), dst (7 x N);
// k_launch_floor at k_step_gates' grid and block with the fall-freeze on.
int avbd_launch_floor(void** ptrs, int n, int loads, float freeze_y, void* stream) {
  k_launch_floor<<<gates_blocks(n, true), GATES_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)ptrs[0], (const float*)ptrs[1], (const float*)ptrs[2], (float*)ptrs[3], n,
      loads, freeze_y);
  return (int)cudaGetLastError();
}

// ptrs: pos, quat, linvel, angvel, prev_linvel, prev_angvel, inv_mass,
// count, other, lam, then pos, quat, linvel, angvel, prev_linvel,
// prev_angvel, diag (16 floats), then scratch: BAL_F + BAL_I fold words and
// the ticket (0 before the launch and after it).  The grid: a block for
// each 32 bodies or for each 256 slots, whichever is more, at most
// STAGE_BLOCKS_PER_SM blocks an SM; the warps stride over the rest.
// AVBD_BAL_BLOCKS (kernels.build's defines, for checks and comparisons
// only) sets another grid.
int avbd_ballistic_step(void** ptrs, const float* params, int n, int dc, void* stream) {
  BallisticArgs a;
  a.pos = (const float*)ptrs[0];
  a.quat = (const float*)ptrs[1];
  a.lv = (const float*)ptrs[2];
  a.av = (const float*)ptrs[3];
  a.prev_lv = (const float*)ptrs[4];
  a.prev_av = (const float*)ptrs[5];
  a.inv_mass = (const float*)ptrs[6];
  a.count = (const int*)ptrs[7];
  a.other = (const int*)ptrs[8];
  a.lam = (const float*)ptrs[9];
  a.pos_out = (float*)ptrs[10];
  a.quat_out = (float*)ptrs[11];
  a.lv_out = (float*)ptrs[12];
  a.av_out = (float*)ptrs[13];
  a.prev_lv_out = (float*)ptrs[14];
  a.prev_av_out = (float*)ptrs[15];
  a.diag = (float*)ptrs[16];
  a.fold = (unsigned int*)ptrs[17];
  a.n = n;
  a.dc = dc;
  KParams p = *(const KParams*)params;
#ifdef AVBD_BAL_BLOCKS
  const int blocks = AVBD_BAL_BLOCKS;
#else
  const int slot_blocks = (dc * n + BAL_SLOT_WARPS * 32 - 1) / (BAL_SLOT_WARPS * 32);
  const int body_blocks = (n + 31) / 32;
  int blocks = 0;
  const cudaError_t err = stage_grid(slot_blocks > body_blocks ? slot_blocks : body_blocks,
                                     &blocks);
  if (err != cudaSuccess) return (int)err;
#endif
  k_ballistic_step<<<blocks, BAL_THREADS, 0, (cudaStream_t)stream>>>(a, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
