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

// Block tree reduction of 8 lanes: op 0 = max, 1 = min, 2 = sum.
static __device__ void block_reduce(float* vals, const int* ops, int k, float* sh) {
  int tid = threadIdx.x;
  for (int j = 0; j < k; ++j) sh[j * CTRL_THREADS + tid] = vals[j];
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) {
      for (int j = 0; j < k; ++j) {
        float a = sh[j * CTRL_THREADS + tid], b = sh[j * CTRL_THREADS + tid + s];
        sh[j * CTRL_THREADS + tid] = ops[j] == 0 ? fmaxf(a, b) : (ops[j] == 1 ? fminf(a, b) : a + b);
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
      float gap = fmaxf(fmaxf(fabsf(pp.x - pos.x) - (wh.x + pwh.x),
                              fabsf(pp.y - pos.y) - (wh.y + pwh.y)),
                        fabsf(pp.z - pos.z) - (wh.z + pwh.z));
      if (valid) min_gap = fminf(min_gap, gap);
      float reach = (travel_i + travel_of(in, idx, p)) + p.reach_const;
      near = near || (valid && (gap - reach <= p.collision_margin));
    }
    V3 lv = ld3(in.lv, i, n);
    float speed_sq = lv.x * lv.x + lv.y * lv.y + lv.z * lv.z;
    bool dyn = in.inv_mass[i] > F(0.0);
    bool alive = dyn && (p.has_fall_freeze == F(0.0) || pos.y >= p.fall_freeze_y);
    float v2 = alive ? speed_sq : F(0.0);
    gate = fmaxf(gate, v2);
    near_speed = fmaxf(near_speed, near ? v2 : F(0.0));
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
    dev_mm = fmaxf(dev_mm, moved ? dev : F(0.0));
    dev_raw = fmaxf(dev_raw, moved ? sqrtf(disp2) + chord : F(0.0));
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
