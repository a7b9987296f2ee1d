// Shared device code of the step kernels: component math in the reference's
// operation order, the parameter block, and the control-lanes reduction.
//
// Every expression repeats the PyTorch plain version (avbd3d_tpu_torch/cm.py,
// ops/*.py, solver_cuda.py) statement for statement, and the library is built
// with --fmad=false and without fast math, so each float operation rounds as
// the plain version's does: identical inputs give identical integer outputs
// (slots, feature ids, counts) and identical or near-identical floats (slot
// sums are taken in the same order; only block-wide float sums differ).
//
// Constants are written F(x): the double literal rounded to float, the path a
// Python float takes into a float32 op in PyTorch and in JAX.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define F(x) ((float)(x))
#define FULL_MASK 0xffffffffu

// A build for the race check only (kernels.build with the define
// AVBD_RACE_DELAY=ns): odd thread blocks sleep this many ns before each read
// of other blocks' data and before each write that other blocks read (K1's
// resident sweeps: poses; K2 and K7: per-body values, partials, the ticket),
// so that a missing barrier or fence shows as different bits rather than
// hiding behind the blocks' usual timing.  Never defined on the main path.
#ifdef AVBD_RACE_DELAY
#define RACE_DELAY()                                   \
  do {                                                 \
    if (blockIdx.x & 1) __nanosleep(AVBD_RACE_DELAY);  \
  } while (0)
#else
#define RACE_DELAY() \
  do {               \
  } while (0)
#endif

// Host-computed float parameters.  The order is the contract with
// avbd3d_tpu_torch/kernels.py (_PARAM_NAMES); avbd_n_params() reports the
// count so the binding can check it.
struct KParams {
  float dt;
  float inv_dt2;
  float gdt2[3];        // gravity[k] * dt * dt
  float grav[3];
  float ghat[3];        // gravity / |gravity| (0 when gravity ~ 0)
  float g_len;
  float has_gravity;    // 1 when |gravity| > 1e-5
  float half_dt;        // 0.5 * dt
  float alpha;
  float beta2;          // beta * 2 (the linear row weight)
  float beta_ang;       // beta * angular_beta_scale
  float gamma;
  float decay;          // alpha * gamma
  float penalty_min;
  float penalty_max;
  float manifold_penalty_cap;
  float collision_margin;
  float precull_margin; // collision_margin + 1e-4
  float stick_thresh_sq;
  float penetration_slop;
  float normal_contact_margin;
  float ws2;            // warmstart_max_drift ** 2
  float st2;            // stick_anchor_max_drift ** 2
  float warmstart_normal_min_dot;
  float stick_normal_min_dot;
  float normal_force_cap;
  float linear_damping;
  float angular_damping;
  float max_angular_speed;
  float relaxation;
  float reach_const;    // 4 * dt**2 * |gravity|
  float fall_freeze_y;
  float has_fall_freeze;
  float post_stabilize;
  float beta;             // the joint rows' linear ramp weight
  float joint_penalty_cap;
  float joint_dual_rate;
  float joint_ema_rate;
};

struct V3 {
  float x, y, z;
};

struct Q4 {
  float x, y, z, w;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 vadd(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 vsub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 vscale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 vneg(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float vdot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 vcross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}

// jnp.clip / torch.clamp: min(max(x, lo), hi)
__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ bool finite3(V3 v) {
  return isfinite(v.x) && isfinite(v.y) && isfinite(v.z);
}

__device__ __forceinline__ Q4 qmul(Q4 a, Q4 b) {
  return Q4{a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
            a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
            a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w,
            a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z};
}

__device__ __forceinline__ Q4 qconj(Q4 q) { return Q4{-q.x, -q.y, -q.z, q.w}; }

__device__ __forceinline__ V3 qrotate(Q4 q, V3 v) {
  V3 qv = v3(q.x, q.y, q.z);
  V3 t = vscale(vcross(qv, v), F(2.0));
  return vadd(vadd(v, vscale(t, q.w)), vcross(qv, t));
}

__device__ __forceinline__ V3 qrotate_inv(Q4 q, V3 v) { return qrotate(qconj(q), v); }

// Box axes (columns of the rotation matrix) from a quat.
__device__ __forceinline__ void qaxes(Q4 q, V3 ax[3]) {
  float xx = q.x * q.x, yy = q.y * q.y, zz = q.z * q.z;
  float xy = q.x * q.y, xz = q.x * q.z, yz = q.y * q.z;
  float wx = q.w * q.x, wy = q.w * q.y, wz = q.w * q.z;
  ax[0] = v3(F(1.0) - F(2.0) * (yy + zz), F(2.0) * (xy + wz), F(2.0) * (xz - wy));
  ax[1] = v3(F(2.0) * (xy - wz), F(1.0) - F(2.0) * (xx + zz), F(2.0) * (yz + wx));
  ax[2] = v3(F(2.0) * (xz + wy), F(2.0) * (yz - wx), F(1.0) - F(2.0) * (xx + yy));
}

__device__ __forceinline__ V3 normalize_or(V3 a, V3 fallback) {
  float lsq = vdot(a, a);
  bool bad = lsq < F(1e-6);
  float inv = bad ? F(0.0) : F(1.0) / sqrtf(bad ? F(1.0) : lsq);
  return bad ? fallback : vscale(a, inv);
}

__device__ __forceinline__ Q4 q_normalize(Q4 q) {
  float msq = q.x * q.x + q.y * q.y + q.z * q.z + q.w * q.w;
  bool bad = msq < F(1e-6);
  float inv = bad ? F(0.0) : F(1.0) / sqrtf(bad ? F(1.0) : msq);
  if (bad) return Q4{0.f, 0.f, 0.f, 1.f};
  return Q4{q.x * inv, q.y * inv, q.z * inv, q.w * inv};
}

// World-frame AABB half extents of an oriented box.
__device__ __forceinline__ V3 world_halves(Q4 q, V3 h) {
  V3 ax[3];
  qaxes(q, ax);
  return v3(h.x * fabsf(ax[0].x) + h.y * fabsf(ax[1].x) + h.z * fabsf(ax[2].x),
            h.x * fabsf(ax[0].y) + h.y * fabsf(ax[1].y) + h.z * fabsf(ax[2].y),
            h.x * fabsf(ax[0].z) + h.y * fabsf(ax[1].z) + h.z * fabsf(ax[2].z));
}

// Strided component accessors: leaf[c * n + i] for a (C, N) leaf.
__device__ __forceinline__ V3 ld3(const float* p, int i, int n) {
  return v3(p[i], p[n + i], p[2 * n + i]);
}
__device__ __forceinline__ Q4 ld4(const float* p, int i, int n) {
  return Q4{p[i], p[n + i], p[2 * n + i], p[3 * n + i]};
}
__device__ __forceinline__ void st3(float* p, int i, int n, V3 v) {
  p[i] = v.x;
  p[n + i] = v.y;
  p[2 * n + i] = v.z;
}
__device__ __forceinline__ void st4(float* p, int i, int n, Q4 q) {
  p[i] = q.x;
  p[n + i] = q.y;
  p[2 * n + i] = q.z;
  p[3 * n + i] = q.w;
}

// ---------------------------------------------------------------------------
// Control lanes (state.Diagnostics lanes 11-15), one thread block.
//
// Two reductions over bodies: min/max lanes in one pass, then the anchor
// deviation from the mean displacement of moved bodies in a second pass.
// Min and max are exact in any order; the three displacement sums (and so
// bp_dev_mm) differ from the plain version's torch.sum by rounding only.
// ---------------------------------------------------------------------------

#define CTRL_THREADS 1024

struct CtrlIn {
  const int* nb;        // (D, N) candidate partner, -1 empty
  const float* pos;     // (3, N)
  const float* quat;    // (4, N)
  const float* size;    // (3, N) extents (half = size * 0.5)
  const float* radius;  // (N)
  const float* lv;      // (3, N)
  const float* av;      // (3, N)
  const float* inv_mass;
  const float* anchor;  // (3, N)
  const float* anchor_q;  // (4, N)
  int n;
  int d;
};

__device__ __forceinline__ float travel_of(const CtrlIn& in, int i, const KParams& p) {
  V3 lv = ld3(in.lv, i, in.n), av = ld3(in.av, i, in.n);
  float speed = sqrtf(lv.x * lv.x + lv.y * lv.y + lv.z * lv.z);
  float wspin = sqrtf(av.x * av.x + av.y * av.y + av.z * av.z) * fmaxf(in.radius[i], F(0.0));
  return (speed + wspin) * p.dt;
}

__device__ __forceinline__ V3 half_of(const float* size, int i, int n) {
  return v3(size[i] * F(0.5), size[n + i] * F(0.5), size[2 * n + i] * F(0.5));
}

// torch.max's max and torch.min's min: NaN if either is NaN (fmaxf and
// fminf drop a NaN); on other values their bits.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

// Block tree reduction of 8 lanes: op 0 = max, 1 = min (NaN propagating,
// as the plain version's torch.max / torch.min), 2 = sum.
static __device__ void block_reduce(float* vals, const int* ops, int k, float* sh) {
  int tid = threadIdx.x;
  for (int j = 0; j < k; ++j) sh[j * CTRL_THREADS + tid] = vals[j];
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) {
      for (int j = 0; j < k; ++j) {
        float a = sh[j * CTRL_THREADS + tid], b = sh[j * CTRL_THREADS + tid + s];
        sh[j * CTRL_THREADS + tid] = ops[j] == 0 ? max_nan(a, b) : (ops[j] == 1 ? min_nan(a, b) : a + b);
      }
    }
    __syncthreads();
  }
  for (int j = 0; j < k; ++j) vals[j] = sh[j * CTRL_THREADS];
  __syncthreads();
}

// Computes the 5 lanes into out[0..4] (written by thread 0).  ``sh`` holds
// 8 * CTRL_THREADS floats of shared memory.  blockDim.x must be a power of 2.
static __device__ void control_lanes_block(const CtrlIn& in, const KParams& p, float* out, float* sh) {
  const int n = in.n;
  float min_gap = F(1.0e9), gate = F(0.0), near_speed = F(0.0);
  float nm = F(0.0), s0 = F(0.0), s1 = F(0.0), s2 = F(0.0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    V3 pos = ld3(in.pos, i, n);
    Q4 q = ld4(in.quat, i, n);
    V3 wh = world_halves(q, half_of(in.size, i, n));
    float travel_i = travel_of(in, i, p);
    bool near = false;
    for (int d = 0; d < in.d; ++d) {
      int nbv = in.nb[d * n + i];
      bool valid = nbv >= 0;
      int idx = valid ? nbv : 0;
      V3 pp = ld3(in.pos, idx, n);
      V3 pwh = world_halves(ld4(in.quat, idx, n), half_of(in.size, idx, n));
      float gap = max_nan(max_nan(fabsf(pp.x - pos.x) - (wh.x + pwh.x),
                                  fabsf(pp.y - pos.y) - (wh.y + pwh.y)),
                          fabsf(pp.z - pos.z) - (wh.z + pwh.z));
      if (valid) min_gap = min_nan(min_gap, gap);
      float reach = (travel_i + travel_of(in, idx, p)) + p.reach_const;
      near = near || (valid && (gap - reach <= p.collision_margin));
    }
    V3 lv = ld3(in.lv, i, n);
    float speed_sq = lv.x * lv.x + lv.y * lv.y + lv.z * lv.z;
    bool dyn = in.inv_mass[i] > F(0.0);
    bool alive = dyn && (p.has_fall_freeze == F(0.0) || pos.y >= p.fall_freeze_y);
    float v2 = alive ? speed_sq : F(0.0);
    gate = max_nan(gate, v2);
    near_speed = max_nan(near_speed, near ? v2 : F(0.0));
    V3 disp = vsub(pos, ld3(in.anchor, i, n));
    float disp2 = disp.x * disp.x + disp.y * disp.y + disp.z * disp.z;
    bool moved = dyn || disp2 > F(0.0);
    float mf = moved ? F(1.0) : F(0.0);
    nm += mf;
    s0 += disp.x * mf;
    s1 += disp.y * mf;
    s2 += disp.z * mf;
  }
  float v1[7] = {min_gap, gate, near_speed, nm, s0, s1, s2};
  const int ops1[7] = {1, 0, 0, 2, 2, 2, 2};
  block_reduce(v1, ops1, 7, sh);
  float nmc = fmaxf(v1[3], F(1.0));
  V3 t = v3(v1[4] / nmc, v1[5] / nmc, v1[6] / nmc);
  float dev_mm = F(0.0), dev_raw = F(0.0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    V3 pos = ld3(in.pos, i, n);
    V3 disp = vsub(pos, ld3(in.anchor, i, n));
    float disp2 = disp.x * disp.x + disp.y * disp.y + disp.z * disp.z;
    bool moved = in.inv_mass[i] > F(0.0) || disp2 > F(0.0);
    Q4 q = ld4(in.quat, i, n), qa = ld4(in.anchor_q, i, n);
    Q4 dq = qmul(q, Q4{-qa.x, -qa.y, -qa.z, qa.w});
    float svec = sqrtf(dq.x * dq.x + dq.y * dq.y + dq.z * dq.z);
    float chord = F(2.0) * fminf(svec, F(1.0)) * fmaxf(in.radius[i], F(0.0));
    V3 e = vsub(disp, t);
    float dev = sqrtf(e.x * e.x + e.y * e.y + e.z * e.z) + chord;
    dev_mm = max_nan(dev_mm, moved ? dev : F(0.0));
    dev_raw = max_nan(dev_raw, moved ? sqrtf(disp2) + chord : F(0.0));
  }
  float v2r[2] = {dev_mm, dev_raw};
  const int ops2[2] = {0, 0};
  block_reduce(v2r, ops2, 2, sh);
  if (threadIdx.x == 0) {
    out[0] = v1[1];
    out[1] = v1[2];
    out[2] = v1[0];
    out[3] = v2r[0];
    out[4] = v2r[1];
  }
}

// ---------------------------------------------------------------------------
// The anchor deviation (the broadphase cache's two reuse bounds, the plain
// version's ops/broadphase.anchor_deviation), shared by K2
// (control_lanes.cu, lanes 3 and 4) and the refresh predicate
// (bp_refresh.cu, k_refresh_needed), so that both give the same bits:
//
// - per body, anchor_terms: the displacement from the anchor, whether the
//   body moved and its rotation chord;
// - per group of LANES_WARPS bodies (K2's block), fold_group: each partial
//   folded over the group's bodies in body order (LANE_PARTS partials:
//   min gap, gate, near speed, dev_raw, moved count, the three displacement
//   sums; the refresh predicate fills 3-7);
// - over the groups, fold_parts_warp: one warp a partial, lane l over
//   groups l, l + 32, ... in index order, then a fixed shuffle tree;
// - dev_mm_block: the largest |disp - t| + chord over moved bodies (a max,
//   exact in any order).
// ---------------------------------------------------------------------------

#define LANES_WARPS 8
#define LANE_PARTS 8  // min gap, gate, near speed, dev_raw, nm, s0, s1, s2

// op 0 min, 1 max, 2 sum: the fold of partial k.  The min and the max
// keep a NaN (min_nan, max_nan), as the plain version's torch.min /
// torch.max do: a NaN pose gives NaN lanes on both sides.
__device__ __forceinline__ int part_op(int k) { return k == 0 ? 0 : (k < 4 ? 1 : 2); }

__device__ __forceinline__ float fold(int op, float a, float b) {
  return op == 0 ? min_nan(a, b) : (op == 1 ? max_nan(a, b) : a + b);
}

struct AnchorTerms {
  V3 disp;      // pos - anchor
  float disp2;  // |disp|^2
  bool moved;   // dynamic, or displaced
  float chord;  // 2 * min(|vec(q (x) qa*)|, 1) * max(radius, 0)
};

__device__ __forceinline__ AnchorTerms anchor_terms(V3 pos, Q4 q, V3 anchor, Q4 qa, float radius,
                                                    bool dyn) {
  AnchorTerms a;
  a.disp = vsub(pos, anchor);
  a.disp2 = a.disp.x * a.disp.x + a.disp.y * a.disp.y + a.disp.z * a.disp.z;
  a.moved = dyn || a.disp2 > F(0.0);
  Q4 dq = qmul(q, Q4{-qa.x, -qa.y, -qa.z, qa.w});
  float svec = sqrtf(dq.x * dq.x + dq.y * dq.y + dq.z * dq.z);
  a.chord = F(2.0) * fminf(svec, F(1.0)) * fmaxf(radius, F(0.0));
  return a;
}

// A group's partial: vals[0] folded with vals[1], ..., vals[LANES_WARPS - 1].
__device__ __forceinline__ float fold_group(const float* vals, int op) {
  float v = vals[0];
  for (int w = 1; w < LANES_WARPS; ++w) v = fold(op, v, vals[w]);
  return v;
}

// Partial k over n_groups groups (part: LANE_PARTS floats a group, written
// by other blocks before their ticket), by the whole calling warp; every
// lane returns the result.
__device__ __forceinline__ float fold_parts_warp(const float* part, int n_groups, int k, int lane) {
  const int op = part_op(k);
  float v = k == 0 ? F(1.0e9) : F(0.0);
  for (int b = lane; b < n_groups; b += 32) v = fold(op, v, __ldcg(part + b * LANE_PARTS + k));
  for (int off = 16; off > 0; off >>= 1) v = fold(op, v, __shfl_xor_sync(FULL_MASK, v, off));
  return v;
}

// The largest |disp - t| + chord over the moved bodies of dv (disp.x,
// disp.y, disp.z, chord; chord -1 for a body that has not moved), 0 when
// none moved (a NaN where a term is NaN); called by the whole block, the
// result in thread 0.  sh_dev: blockDim.x / 32 floats of shared memory.
__device__ __forceinline__ float dev_mm_block(const float4* dv, int n, V3 t, float* sh_dev) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float dev_mm = F(0.0);
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float4 v = __ldcg(dv + j);
    if (v.w >= F(0.0)) {  // moved
      V3 e = v3(v.x - t.x, v.y - t.y, v.z - t.z);
      dev_mm = max_nan(dev_mm, sqrtf(e.x * e.x + e.y * e.y + e.z * e.z) + v.w);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    dev_mm = max_nan(dev_mm, __shfl_xor_sync(FULL_MASK, dev_mm, off));
  if (lane == 0) sh_dev[warp] = dev_mm;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) dev_mm = max_nan(dev_mm, sh_dev[w]);
  return dev_mm;
}

// ---------------------------------------------------------------------------
// The stage kernels' shared code (grid_stages.cu: the grid step's gates,
// prediction and finalize; fused_stages.cu: the fused path's gates and its
// ballistic step).  Each repeats a torch stage of the port statement for
// statement: the fall-freeze (solver.freeze_fallen), the prediction of one
// body (solver.predict) and the velocities of finalize (solver.finalize),
// each of the last two in a linear and an angular half that share nothing,
// so that a kernel runs them on two lanes; and the cross-block fold of a
// stage's lanes by atomics (atomic_fold).
// ---------------------------------------------------------------------------

#define STAGE_THREADS 256
#define STAGE_WARPS (STAGE_THREADS / 32)
// The most blocks an SM of the grids sized to the card (k_grid_predict,
// k_grid_finalize, k_ballistic_step).
#define STAGE_BLOCKS_PER_SM 2

// The orders of torch's CUDA reductions over a row's few components, which
// depend on the row's layout: over a component-major (N, C) view (strides
// (1, N)) one thread adds the components in order; over a contiguous (N, 3)
// row, threads pair the components by shuffles, (x^2 + z^2) + y^2.
//   quat_normalize's torch.sum(q * q, dim=-1) (q component-major):
#define QUAT_MSQ(q) ((((q).x * (q).x + (q).y * (q).y) + (q).z * (q).z) + (q).w * (q).w)
//   vector_norm of a component-major row (the angular clamp's angvel, the
//   finalized linvel):
#define VNORM3(v) sqrtf(((v).x * (v).x + (v).y * (v).y) + (v).z * (v).z)
//   vector_norm of a contiguous row (the finalized angvel, built by
//   quat_mul's torch.stack):
#define VNORM3_XZY(v) sqrtf(((v).x * (v).x + (v).z * (v).z) + (v).y * (v).y)


__device__ __forceinline__ bool finite4(Q4 q) {
  return isfinite(q.x) && isfinite(q.y) && isfinite(q.z) && isfinite(q.w);
}

// solver.freeze_fallen for one body: a dynamic body below freeze_y
// (frozen) becomes static with zeroed velocities (torch.where(frozen, 0.0,
// x)).
__device__ __forceinline__ bool frozen(float im, float py, float freeze_y) {
  return im > F(0.0) && py < freeze_y;
}
__device__ __forceinline__ void freeze_body(V3 pos, float freeze_y, V3* lv, V3* av, float* im) {
  if (frozen(*im, pos.y, freeze_y)) {
    *lv = v3(F(0.0), F(0.0), F(0.0));
    *av = *lv;
    *im = F(0.0);
  }
}

// solver.predict for one body in two halves, each adding the rows it
// sanitizes to *san.  The linear half: the sanitized linvel, the inertial
// position and the accel-weighted warm start (its row sanitized); the
// angular half: the clamped and sanitized angvel and the inertial
// quaternion (also the iterations' start).
struct PredLinear {
  V3 lv;  // sanitized linvel
  V3 ip;  // inertial position
  V3 ps;  // warm start position
};
struct PredAngular {
  V3 av;  // clamped, sanitized angvel
  Q4 iq;  // inertial quaternion
};

__device__ __forceinline__ PredLinear predict_linear(V3 pos0, V3 lv, V3 prev_lv, bool dyn,
                                                     const KParams& p, int* san) {
  PredLinear r;
  const float dt = p.dt;
  if (!finite3(lv)) {
    lv = v3(F(0.0), F(0.0), F(0.0));
    ++*san;
  }
  // pos0 + linvel * dt + gravity * dt * dt
  const V3 g2 = v3((p.grav[0] * dt) * dt, (p.grav[1] * dt) * dt, (p.grav[2] * dt) * dt);
  r.ip = dyn ? vadd(vadd(pos0, vscale(lv, dt)), g2) : pos0;
  float aw = F(0.0);
  if (p.has_gravity != F(0.0)) {
    const V3 acc = vsub(lv, prev_lv);  // cm.div(linvel - prev_linvel, dt)
    const V3 accel = v3(acc.x / dt, acc.y / dt, acc.z / dt);
    const float projected = (accel.x * p.ghat[0] + accel.y * p.ghat[1]) + accel.z * p.ghat[2];
    aw = clipf(projected / p.g_len, F(0.0), F(1.0));
    if (!isfinite(aw)) aw = F(0.0);
  }
  // pos0 + (linvel * dt + gravity * (accel_weight * dt * dt)) * dynf
  const float dynf = dyn ? F(1.0) : F(0.0);
  const float awdt2 = (aw * dt) * dt;
  r.ps = v3(pos0.x + (lv.x * dt + p.grav[0] * awdt2) * dynf,
            pos0.y + (lv.y * dt + p.grav[1] * awdt2) * dynf,
            pos0.z + (lv.z * dt + p.grav[2] * awdt2) * dynf);
  if (!finite3(r.ps)) {
    r.ps = pos0;
    ++*san;
  }
  r.lv = lv;
  return r;
}

__device__ __forceinline__ PredAngular predict_angular(Q4 q0, V3 av, bool dyn, const KParams& p,
                                                       int* san) {
  PredAngular r;
  // _clamp_angular: w * where(speed > max, max / clamp(speed, 1e-12), 1)
  const float speed = VNORM3(av);
  const float scale = speed > p.max_angular_speed
                          ? p.max_angular_speed / fmaxf(speed, F(1e-12)) : F(1.0);
  av = vscale(av, scale);
  if (!finite3(av)) {
    av = v3(F(0.0), F(0.0), F(0.0));
    ++*san;
  }
  // quat_normalize(quat0 + quat_mul(omega_q, quat0) * (0.5 * dt))
  const Q4 qm = qmul(Q4{av.x, av.y, av.z, F(0.0)}, q0);
  const Q4 q = Q4{q0.x + qm.x * p.half_dt, q0.y + qm.y * p.half_dt, q0.z + qm.z * p.half_dt,
                  q0.w + qm.w * p.half_dt};
  const float msq = QUAT_MSQ(q);
  const bool bad = msq < F(1e-6);
  const float safe = sqrtf(bad ? F(1.0) : msq);
  r.iq = bad ? Q4{F(0.0), F(0.0), F(0.0), F(1.0)}
             : Q4{q.x / safe, q.y / safe, q.z / safe, q.w / safe};
  if (!dyn) r.iq = q0;
  r.av = av;
  return r;
}

// solver.finalize's velocities of one body from its final pose (pf, qf)
// and its start (pos0, q0): damped, a static body keeping its own (lv0,
// av0), each sanitized (adds to *san); the linear and the angular half.
__device__ __forceinline__ V3 finalize_linear(V3 pf, V3 pos0, V3 lv0, bool dyn, const KParams& p,
                                              int* san) {
  const float dt = p.dt;
  // cm.div(pos_f - pos0, dt) * linear_damping
  const V3 dp = vsub(pf, pos0);
  V3 nl = vscale(v3(dp.x / dt, dp.y / dt, dp.z / dt), p.linear_damping);
  if (!dyn) nl = lv0;
  if (!finite3(nl)) {
    nl = v3(F(0.0), F(0.0), F(0.0));
    ++*san;
  }
  return nl;
}
__device__ __forceinline__ V3 finalize_angular(Q4 qf, Q4 q0, V3 av0, bool dyn, const KParams& p,
                                               int* san) {
  const float dt = p.dt;
  // quat_vec_doubled(quat_f (x) conj(quat0)) / dt * angular_damping
  const Q4 dq = qmul(qf, qconj(q0));
  const float sign = dq.w < F(0.0) ? F(-1.0) : F(1.0);
  const V3 vd = v3((F(2.0) * dq.x) * sign, (F(2.0) * dq.y) * sign, (F(2.0) * dq.z) * sign);
  V3 na = vscale(v3(vd.x / dt, vd.y / dt, vd.z / dt), p.angular_damping);
  if (!dyn) na = av0;
  if (!finite3(na)) {
    na = v3(F(0.0), F(0.0), F(0.0));
    ++*san;
  }
  return na;
}

// max_nan's order on floats as unsigned ints, for atomicMax: a NaN above
// every float, -0 below +0, and 0 (the fold's start) below every key.
__device__ __forceinline__ unsigned int max_key(float x) {
  const unsigned int u = __float_as_uint(x);
  return x != x ? 0xffffffffu : ((u & 0x80000000u) ? ~u : (u | 0x80000000u));
}
__device__ __forceinline__ float max_of_key(unsigned int k) {
  return k == 0xffffffffu ? __uint_as_float(0x7fffffffu)
                          : __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// atomicAdd with release and acquire semantics at device scope: the ticket
// of atomic_fold.  Its release makes the warp's earlier atomics on the
// fold's words (ordered before it by __syncwarp) visible to the block that
// reads the ticket after it; its acquire makes every earlier ticket's words
// visible to this block.  It replaces a __threadfence on either side of the
// ticket: the release still waits (~0.75 us on the card), the acquire side
// no longer does (PERF.md section 6).
__device__ __forceinline__ unsigned int atomic_add_acq_rel(unsigned int* p, unsigned int v) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;" : "=r"(old) : "l"(p), "r"(v)
               : "memory");
  return old;
}

// The cross-block fold of a stage kernel's lanes by atomics, called by
// every thread of every block (W warps a block): NQ quantities a thread in
// q, the first NF maxima as max_key, the rest int sums.  Each warp reduces
// each quantity in one instruction (__reduce_max_sync / __reduce_add_sync),
// warp 0 folds the warps the same way, its lane k folds quantity k into
// fold[k] (atomicMax of the key, atomicAdd of the sum: exact in any order),
// and lane 0 takes the ticket fold[NQ] (atomic_add_acq_rel).  Returns true
// in warp 0 of the last block, each lane k < NQ holding word k (read and
// reset to 0), the ticket reset to 0; the caller's last block writes the
// lanes.  A maximum's key order is max_nan's on values, so the lanes equal
// the plain version's (a NaN as the canonical NaN, a zero as +0 when any
// thread holds +0).  No block walks other blocks' partials (a last block
// that did, one warp a quantity, set the time of the kernels that had it).
template <int NF, int NQ, int W>
__device__ __forceinline__ bool atomic_fold(const unsigned int (&q)[NQ],
                                            unsigned int (&shk)[NQ][W], unsigned int* fold,
                                            unsigned int* word) {
  static_assert(NQ <= 32 && W <= 32, "a lane a quantity, a lane a warp");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned int mine = 0;  // lane k: quantity k over the warp, then the block
#pragma unroll
  for (int k = 0; k < NQ; ++k) {
    const unsigned int v = k < NF ? __reduce_max_sync(FULL_MASK, q[k])
                                  : __reduce_add_sync(FULL_MASK, q[k]);
    if (lane == k) mine = v;
  }
  if (lane < NQ) shk[lane][warp] = mine;
  __syncthreads();
  if (warp != 0) return false;
#pragma unroll
  for (int k = 0; k < NQ; ++k) {
    const unsigned int x = lane < W ? shk[k][lane] : 0u;
    const unsigned int v = k < NF ? __reduce_max_sync(FULL_MASK, x)
                                  : __reduce_add_sync(FULL_MASK, x);
    if (lane == k) mine = v;
  }
  RACE_DELAY();
  if (lane < NF) atomicMax(fold + lane, mine);
  else if (lane < NQ) atomicAdd(fold + lane, mine);
  __syncwarp();  // the warp's atomics, then lane 0's release
  unsigned int last = 0;
  if (lane == 0) {
    RACE_DELAY();
    last = atomic_add_acq_rel(fold + NQ, 1u) == gridDim.x - 1 ? 1u : 0u;
  }
  if (!__shfl_sync(FULL_MASK, last, 0)) return false;
  __syncwarp();  // lane 0's acquire, then the warp's reads
  *word = lane < NQ ? atomicExch(fold + lane, 0u) : 0u;
  if (lane == 0) fold[NQ] = 0u;
  return true;
}

// The one-word form of atomic_fold, for a single int sum: each block's sum
// and its ticket travel in one 64-bit atomicAdd (the sum in the high word,
// 1 in the low), so the last block learns the total from its own atomic's
// return: no release to wait for and no second round trip (atomic_fold's
// words need both).  Called by every thread of every block (W warps a
// block); returns true in thread 0 of the last block, the total in *total;
// the caller resets *word to 0.
template <int W>
__device__ __forceinline__ bool atomic_count(int v, unsigned int (&sh)[W],
                                             unsigned long long* word, int* total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned int s = __reduce_add_sync(FULL_MASK, (unsigned int)v);
  if (lane == 0) sh[warp] = s;
  __syncthreads();
  if (threadIdx.x != 0) return false;
  unsigned int b = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) b += sh[w];
  RACE_DELAY();
  const unsigned long long old = atomicAdd(word, ((unsigned long long)b << 32) | 1ull);
  if ((unsigned int)old != gridDim.x - 1) return false;
  *total = (int)((unsigned int)(old >> 32) + b);
  return true;
}

// The grid of a stage kernel sized to the card: ``want`` blocks (the
// blocks its data would fill), at most STAGE_BLOCKS_PER_SM an SM; the SM
// count read once a process.  cudaSuccess, or the error of that read.
static inline cudaError_t stage_grid(int want, int* blocks) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int most = STAGE_BLOCKS_PER_SM * sms;
  *blocks = want < 1 ? 1 : (want < most ? want : most);
  return cudaSuccess;
}
