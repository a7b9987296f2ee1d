// K1: the fused contact-step kernel.
//
// Replaces step_kernel_tpu / _make_kernel_step (avbd3d_tpu/solver_tpu.py:789-918;
// math _kernel_b_math 280-717, ops/replicated.py collide_and_init, and
// ops/broadphase.py symmetric_filter / control_lanes).  One call of
// avbd_step runs a whole contact step: symmetric filter -> precull to the cache
// width -> 15-axis SAT + warmstart match + row init -> prediction -> the
// Jacobi sweeps -> velocities, sanitize, diagnostics and the control lanes.
//
// What bounds it on the H100: latency and dependent arithmetic, not bytes or
// flops.  The whole (., 12, 8, 128) contact state is ~5 MB, which does not fit
// in 227 KB of shared memory but sits in the 50 MB L2, so it lives in global
// memory and every sweep re-reads it from L2.  What the design does about
// the latency:
//  - The primal pass is slot-parallel.  A thread block owns a tile of 32 or
//    64 bodies and runs one thread per (slot, body): each thread computes its
//    slot's rows, force and (on a rebuild) Hessian terms and leaves 6 or 30
//    partial sums in shared memory; after __syncthreads() thread (component,
//    body) folds the partials over the slots, left to right from slot 0 (the
//    order cm.dsum folds in, so the sums keep their bits); then one thread
//    per body runs the 6x6 solve and the pose update.  The dependent chain of
//    a sweep is 12 rows + DC adds + one solve instead of DC x 12 rows, on
//    N / tile blocks of tile x DC threads.
//  - A Jacobi sweep needs every body's new pose before any dual update
//    (solver_tpu.py:543-548).  Where a logical block of bodies (the whole
//    world here, blk bodies on the grid tier) fits one thread-block cluster
//    (at most 16 blocks of 64 bodies), the whole sweep loop is ONE launch,
//    k_sweeps, with the cluster's hardware barrier as that barrier; only the
//    poses cross threads, through L2.  Larger contact-only worlds take one
//    launch per half-sweep.  A world with joint or spring rows runs all its
//    sweeps and colour sub-passes (which ping-pong two pose buffers) in ONE
//    launch, k_joint_sweeps, with the cluster's barrier or, above one
//    cluster, a grid barrier in a cooperative launch.  Which route a shape
//    takes is decided before the launch by solver_cuda.sweep_plan, whose
//    numbers the entry points receive; a resident launch that cannot be
//    scheduled is an error.
//  - The collide is lane-parallel: a warp per body filters and culls its
//    candidate slots, a group of lanes per slot runs the SAT and the clip.
//   k_filter_cull   1 warp / body           symmetric filter + ordered precull
//   k_collide       4 lanes / (slot, body)  SAT, clip, warmstart match, row
//                                           init, once-per-pair flag
//   k_predict       1 thread / body         prediction
//   cluster route:
//     k_sweeps      tile x lanes threads    geometry at the predicted poses,
//                                           then every sweep (primal pass,
//                                           cluster barrier, dual pass,
//                                           cluster barrier)
//   launch route:
//     k_geom        1 thread / (slot, body) geometry at the predicted poses
//     per sweep:
//       k_primal    tile x lanes threads    slot partials, ordered fold, 6x6
//                                           (rebuilt at block heads), solve66,
//                                           relaxed update
//       k_dual      1 thread / (slot, body) geometry at the new poses, dual
//                                           update, ramp at block tails
//   rows (cluster or grid barrier):
//     k_joint_sweeps tile x lanes threads   rows' decay, geometry, then every
//                                           sweep (primal partials and fold,
//                                           per colour the sub-pass and the
//                                           barrier, contact and joint duals)
//   k_final_body    1 thread / body         sanitize, velocities
//   k_joint_ema     1 thread / joint slot   the slow joint dual tracker
//   k_final_reduce  1 block                 diagnostics lanes + control lanes
// 6 launches per contact step on the cluster route, 6 + 2 per sweep on the
// launch route, 7 per jointed step.  The iteration count and the Hessian
// cadence are runtime arguments, so the calm, fresh and boosted variants
// share this code.
//
// Replica symmetry: every slot computes in the canonical A/B frame (A = lower
// body index) from canonical operands, so both replicas of a pair execute the
// same arithmetic and their duals stay bit-identical with no synchronisation.
// (Not on the grid tier: there the two replicas of a pair that spans two
// logical blocks read different partner poses, and their duals differ by
// design; see grid_kernels.cu.)
// Built with --fmad=false and without fast math: each statement rounds as the
// plain PyTorch version's op does (see avbd_common.cuh).
#include "step_kernel.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

// ---------------------------------------------------------------------------
// Narrowphase: collide_pairs_cm for one pair (ops/narrowphase_cm.py), by a
// group of W lanes (COLLIDE_LANES below).  Every statement is
// the plain version's; the lanes split the 15 SAT axes and the 24 clip
// candidates between them (lane L takes axes and candidates L, L + W, ...),
// and each arg-max scan becomes a lane-local scan and a group reduction
// that picks the serial scan's index.
// ---------------------------------------------------------------------------

// Lane of a thread within its group of W lanes, and the group's first lane
// in the warp.
template <int W>
__device__ __forceinline__ int grp_lane() { return threadIdx.x & (W - 1); }
template <int W>
__device__ __forceinline__ int grp_first() { return (threadIdx.x & 31) & ~(W - 1); }

template <int W, typename T>
__device__ __forceinline__ T grp_shfl(T v, int src) {
  return __shfl_sync(FULL_MASK, v, src, W);
}
// The group's bits of a warp-wide ballot (bit k: lane k of the group).
template <int W>
__device__ __forceinline__ unsigned grp_ballot(bool pred) {
  return (__ballot_sync(FULL_MASK, pred) >> grp_first<W>()) & ((1u << W) - 1u);
}

// The serial scan "best = s[0]; for k >= 1: if (s[k] > best) take k" as a
// reduction in any order.  Its key for s[k] is s[k], except for NaN, which
// the scan keeps at k = 0 (nothing compares greater) and skips elsewhere:
// +inf there, -inf here.  The largest key wins, the lowest index among equal
// keys (the scan's strict >), so the winner is the scan's index.
__device__ __forceinline__ float scan_key(float s, int k) {
  return isnan(s) ? (k == 0 ? INFINITY : -INFINITY) : s;
}
__device__ __forceinline__ bool beats(float ka, int ia, float kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}
// (key, index) reduced over the group; every lane receives the winner.
// Lanes without an element hold (-inf, NO_INDEX).
#define NO_INDEX 64
template <int W>
__device__ __forceinline__ void grp_argmax(float* key, int* idx) {
#pragma unroll
  for (int off = 1; off < W; off <<= 1) {
    float k2 = __shfl_xor_sync(FULL_MASK, *key, off, W);
    int i2 = __shfl_xor_sync(FULL_MASK, *idx, off, W);
    if (beats(k2, i2, *key, *idx)) {
      *key = k2;
      *idx = i2;
    }
  }
}

// items[k] of a lane's small array at a k that is the same on every lane,
// by selects (a dynamic index would put the array in local memory).
template <int K, typename T>
__device__ __forceinline__ T pick_at(const T (&items)[K], int k) {
  T r = items[0];
#pragma unroll
  for (int j = 1; j < K; ++j) r = (k == j) ? items[j] : r;
  return r;
}

__device__ __forceinline__ V3 sel3v(int idx, const V3* items) {
  return idx == 0 ? items[0] : (idx == 1 ? items[1] : items[2]);
}
__device__ __forceinline__ float sel3f(int idx, const float* items) {
  return idx == 0 ? items[0] : (idx == 1 ? items[1] : items[2]);
}
__device__ __forceinline__ float sel4f(int idx, const float* items) {
  return idx == 0 ? items[0] : (idx == 1 ? items[1] : (idx == 2 ? items[2] : items[3]));
}

static __device__ void test_axis(V3 axis, V3 delta, const V3* axa, const V3* axb, V3 ha, V3 hb,
                          float* sep, bool* valid, V3* nout) {
  float lsq = vdot(axis, axis);
  bool degen = lsq < F(1.0e-6);
  float inv = F(1.0) / sqrtf(degen ? F(1.0) : lsq);
  V3 n = vscale(axis, inv);
  bool flip = vdot(n, delta) < F(0.0);
  n = flip ? vneg(n) : n;
  float dist = fabsf(vdot(n, delta));
  float r_a = ha.x * fabsf(vdot(n, axa[0])) + ha.y * fabsf(vdot(n, axa[1])) + ha.z * fabsf(vdot(n, axa[2]));
  float r_b = hb.x * fabsf(vdot(n, axb[0])) + hb.y * fabsf(vdot(n, axb[1])) + hb.z * fabsf(vdot(n, axb[2]));
  *sep = dist - (r_a + r_b);
  *valid = !degen;
  *nout = n;
}

static __device__ void support_edge(const V3* axes, const float* half, int ai, V3 dir, V3* ec, V3* eh) {
  int i1 = (ai + 1) % 3, i2 = (ai + 2) % 3;
  V3 a1 = sel3v(i1, axes), a2 = sel3v(i2, axes);
  float h1 = sel3f(i1, half), h2 = sel3f(i2, half), hx = sel3f(ai, half);
  V3 ax = sel3v(ai, axes);
  float s1 = vdot(dir, a1) >= F(0.0) ? F(1.0) : F(-1.0);
  float s2 = vdot(dir, a2) >= F(0.0) ? F(1.0) : F(-1.0);
  *ec = vadd(vscale(a1, h1 * s1), vscale(a2, h2 * s2));
  *eh = vscale(ax, hx);
}

// Clip candidate c (0-23) of the face manifold in the reference face's
// (u, v) frame: 0-3 the incident corners, 4 + 4 m + side the incident edge m
// clipped at a side of the reference face, 20-23 the reference corners
// inside the incident face.  ``ok`` before the height test.
static __device__ void clip_candidate(int c, const float* cu, const float* cv, float eu, float ev, float wind,
                                      float* u, float* v, bool* ok) {
  if (c < 4) {
    *u = sel4f(c, cu);
    *v = sel4f(c, cv);
    *ok = (fabsf(*u) <= eu + F(1.0e-5)) && (fabsf(*v) <= ev + F(1.0e-5));
  } else if (c < 20) {
    int m = (c - 4) >> 2, side = (c - 4) & 3, m2 = (m + 1) % 4;
    float cum = sel4f(m, cu), cvm = sel4f(m, cv);
    float du = sel4f(m2, cu) - cum;
    float dv = sel4f(m2, cv) - cvm;
    bool side_u = side < 2;
    float side_sign = (side % 2 == 0) ? F(1.0) : F(-1.0);
    float bound, dcoord, ccoord, oc, od, oext;
    if (side_u) {
      bound = eu * side_sign; dcoord = du; ccoord = cum; oc = cvm; od = dv; oext = ev;
    } else {
      bound = ev * side_sign; dcoord = dv; ccoord = cvm; oc = cum; od = du; oext = eu;
    }
    bool denom_ok = fabsf(dcoord) > F(1.0e-6);
    float t = (bound - ccoord) / (denom_ok ? dcoord : F(1.0));
    float hit = oc + t * od;
    *ok = denom_ok && (t >= F(-1.0e-5)) && (t <= F(1.0 + 1.0e-5)) && (fabsf(hit) <= oext + F(1.0e-5));
    // bound + 0 (the reference adds a zero tensor): turns -0 into +0
    float bz = bound + F(0.0);
    *u = side_u ? bz : hit;
    *v = side_u ? hit : bz;
  } else {
    int m = c - 20;
    float ru = ((m == 0 || m == 3) ? F(1.0) : F(-1.0)) * eu;
    float rv = (m < 2 ? F(1.0) : F(-1.0)) * ev;
    bool inside = true;
    for (int e = 0; e < 4; ++e) {
      int e2 = (e + 1) % 4;
      float z = (cu[e2] - cu[e]) * (rv - cv[e]) - (cv[e2] - cv[e]) * (ru - cu[e]);
      inside = inside && ((z * wind) >= F(-1.0e-5));
    }
    *u = ru;
    *v = rv;
    *ok = inside;
  }
}

// The score of a candidate for pick ``pick`` (deepest, farthest from the
// first, +/- largest area with the first two).
__device__ __forceinline__ float pick_score(int pick, float u, float v, float h, const float* pu, const float* pv) {
  if (pick == 0) return -h;
  if (pick == 1) return (u - pu[0]) * (u - pu[0]) + (v - pv[0]) * (v - pv[0]);
  float a01 = (pu[1] - pu[0]) * (v - pv[0]) - (pv[1] - pv[0]) * (u - pu[0]);
  return pick == 2 ? a01 : -a01;
}

// What a lane keeps of a pair's manifold: the normal (every lane) and
// contact L & 3 of the four; ``ok_bits``: bit s = contact s is valid.
struct PairLane {
  V3 normal;      // B -> A
  V3 x_a, x_b;
  int feature;
  bool ok;
  unsigned ok_bits;
};

// Lane L of the group: axes L, L + W, ... of the SAT (0-2 A's
// face axes, 3-5 B's, 6-14 the edge pairs (i, j) = ((a - 6) / 3, (a - 6) %
// 3)), clip candidates L, L + W, ... (of 24), and contact L & 3.
// Every lane of the warp must call it (it shuffles).
template <int W>
static __device__ void collide_pair(int L, V3 pa, Q4 qa, V3 ha, V3 pb, Q4 qb, V3 hb, float margin,
                                    PairLane* out) {
  V3 axa[3], axb[3];
  qaxes(qa, axa);
  qaxes(qb, axb);
  V3 delta = vsub(pb, pa);
  constexpr int NA = (15 + W - 1) / W, NC = (24 + W - 1) / W;   // axes, candidates a lane

  float s_ax[NA];
  V3 n_ax[NA];
  bool sep_lane = false, edge_lane = false;
  float kf = -INFINITY, ke = -INFINITY;
  int best_face = NO_INDEX, best_edge = NO_INDEX;
#pragma unroll
  for (int k = 0; k < NA; ++k) {
    const int ax = L + k * W;
    const bool is_face = ax < 6, is_edge = ax >= 6 && ax < 15;
    const int e = is_edge ? ax - 6 : 0;
    V3 axis = ax < 3 ? sel3v(ax, axa)
                     : (ax < 6 ? sel3v(ax - 3, axb) : vcross(sel3v(e / 3, axa), sel3v(e % 3, axb)));
    float sep;
    bool val;
    test_axis(axis, delta, axa, axb, ha, hb, &sep, &val, &n_ax[k]);
    sep_lane = sep_lane || ((is_face || is_edge) && val && (sep > margin));
    edge_lane = edge_lane || (is_edge && val);
    s_ax[k] = val ? sep : NEG_BIG;
    const float key_f = scan_key(s_ax[k], ax), key_e = scan_key(s_ax[k], e);
    if (is_face && beats(key_f, ax, kf, best_face)) {
      kf = key_f;
      best_face = ax;
    }
    if (is_edge && beats(key_e, e, ke, best_edge)) {
      ke = key_e;
      best_edge = e;
    }
  }
  const bool separated = grp_ballot<W>(sep_lane) != 0u;
  grp_argmax<W>(&kf, &best_face);
  grp_argmax<W>(&ke, &best_edge);
  const bool edge_any = grp_ballot<W>(edge_lane) != 0u;
  // The winners' separations and normals, from the lanes that hold them.
  const int fa = best_face, ea = best_edge + 6;
  const int fk = fa / W, fl = fa % W;
  const int ek = ea / W, el = ea % W;
  const float best_face_sep = grp_shfl<W>(pick_at(s_ax, fk), fl);
  const float best_edge_sep = grp_shfl<W>(pick_at(s_ax, ek), el);
  bool use_edge = edge_any && (F(0.95) * best_edge_sep > best_face_sep + F(0.01)) && (best_edge_sep > F(-0.05));
  const V3 nf = pick_at(n_ax, fk), ne = pick_at(n_ax, ek);
  const V3 normal_ab = v3(grp_shfl<W>(nf.x, fl), grp_shfl<W>(nf.y, fl), grp_shfl<W>(nf.z, fl));
  const V3 edge_n = v3(grp_shfl<W>(ne.x, el), grp_shfl<W>(ne.y, el), grp_shfl<W>(ne.z, el));

  // ---- face manifold (every lane) ----
  bool ref_is_a = best_face < 3;
  int ref_axis = ref_is_a ? best_face : best_face - 3;
  V3 ref_axes[3], inc_axes[3];
  for (int k = 0; k < 3; ++k) {
    ref_axes[k] = ref_is_a ? axa[k] : axb[k];
    inc_axes[k] = ref_is_a ? axb[k] : axa[k];
  }
  V3 ref_center = ref_is_a ? pa : pb;
  V3 inc_center = ref_is_a ? pb : pa;
  float hav[3] = {ha.x, ha.y, ha.z}, hbv[3] = {hb.x, hb.y, hb.z};
  float ref_half[3], inc_half[3];
  for (int k = 0; k < 3; ++k) {
    ref_half[k] = ref_is_a ? hav[k] : hbv[k];
    inc_half[k] = ref_is_a ? hbv[k] : hav[k];
  }
  V3 ref_outward = ref_is_a ? normal_ab : vneg(normal_ab);
  V3 ref_axis_vec = sel3v(ref_axis, ref_axes);
  float sign_ref = vdot(ref_outward, ref_axis_vec) >= F(0.0) ? F(1.0) : F(-1.0);
  V3 n_ref = vscale(ref_axis_vec, sign_ref);
  float ref_h = sel3f(ref_axis, ref_half);
  V3 face_center = vadd(ref_center, vscale(n_ref, ref_h));

  int u_idx = ref_axis == 0 ? 1 : 0;
  int v_idx = ref_axis == 2 ? 1 : 2;
  V3 u_ax = sel3v(u_idx, ref_axes), v_ax = sel3v(v_idx, ref_axes);
  float eu = sel3f(u_idx, ref_half), ev = sel3f(v_idx, ref_half);

  float inc_dots[3];
  for (int k = 0; k < 3; ++k) inc_dots[k] = fabsf(vdot(inc_axes[k], n_ref));
  int inc_axis = 0;
  float best_dot = inc_dots[0];
  for (int k = 1; k < 3; ++k)
    if (inc_dots[k] > best_dot) { best_dot = inc_dots[k]; inc_axis = k; }
  V3 inc_axis_vec = sel3v(inc_axis, inc_axes);
  float sign_inc = vdot(inc_axis_vec, n_ref) > F(0.0) ? F(-1.0) : F(1.0);
  V3 n_inc = vscale(inc_axis_vec, sign_inc);
  float inc_h = sel3f(inc_axis, inc_half);
  V3 inc_face_center = vadd(inc_center, vscale(n_inc, inc_h));

  int iu_idx = inc_axis == 0 ? 1 : 0;
  int iv_idx = inc_axis == 2 ? 1 : 2;
  V3 iu_ax = sel3v(iu_idx, inc_axes), iv_ax = sel3v(iv_idx, inc_axes);
  float ieu = sel3f(iu_idx, inc_half), iev = sel3f(iv_idx, inc_half);

  const float su[4] = {F(1.0), F(-1.0), F(-1.0), F(1.0)};
  const float sv[4] = {F(1.0), F(1.0), F(-1.0), F(-1.0)};
  float cu[4], cv[4];
  for (int m = 0; m < 4; ++m) {
    V3 corner = vadd(inc_face_center, vadd(vscale(iu_ax, su[m] * ieu), vscale(iv_ax, sv[m] * iev)));
    V3 rel = vsub(corner, face_center);
    cu[m] = vdot(rel, u_ax);
    cv[m] = vdot(rel, v_ax);
  }

  float d_nn = vdot(n_inc, n_ref);
  if (fabsf(d_nn) < F(1.0e-6)) d_nn = d_nn < F(0.0) ? F(-1.0e-6) : F(1.0e-6);
  float h0 = vdot(n_inc, vsub(inc_face_center, face_center)) / d_nn;
  float hu = -vdot(n_inc, u_ax) / d_nn;
  float hv = -vdot(n_inc, v_ax) / d_nn;
  float area2 = (cu[1] - cu[0]) * (cv[2] - cv[0]) - (cv[1] - cv[0]) * (cu[2] - cu[0])
              + (cu[2] - cu[0]) * (cv[3] - cv[0]) - (cv[2] - cv[0]) * (cu[3] - cu[0]);
  float wind = area2 >= F(0.0) ? F(1.0) : F(-1.0);

  // ---- this lane's clip candidates: L, L + W, ... below 24 ----
  float cu_[NC], cv_[NC], ch[NC];
  bool va[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = L + k * W;
    bool ok;
    clip_candidate(c < 24 ? c : 0, cu, cv, eu, ev, wind, &cu_[k], &cv_[k], &ok);
    ch[k] = h0 + hu * cu_[k] + hv * cv_[k];
    va[k] = (c < 24) && ok && (ch[k] <= margin);
  }

  // ---- reduce to <= 4 picks: deepest, farthest, +/- max area ----
  float pu[4], pv[4], ph[4];
  bool found[4];
  for (int pick = 0; pick < 4; ++pick) {
    float m[NC];
    float key = -INFINITY;
    int idx = NO_INDEX;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = L + k * W;
      m[k] = va[k] ? pick_score(pick, cu_[k], cv_[k], ch[k], pu, pv) : NEG_BIG;
      const float kk = scan_key(m[k], c);
      if (c < 24 && beats(kk, c, key, idx)) {
        key = kk;
        idx = c;
      }
    }
    grp_argmax<W>(&key, &idx);
    const int src = idx % W, kk = idx / W;
    const float best_s = grp_shfl<W>(pick_at(m, kk), src);
    found[pick] = best_s > F(-3.0e38 * 0.5);
    pu[pick] = grp_shfl<W>(pick_at(cu_, kk), src);
    pv[pick] = grp_shfl<W>(pick_at(cv_, kk), src);
    ph[pick] = grp_shfl<W>(pick_at(ch, kk), src);
    if (pick < 3) {
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        float du = cu_[k] - pu[pick], dv = cv_[k] - pv[pick];
        va[k] = va[k] && ((du * du + dv * dv) >= F(1.0e-6));
      }
    }
  }
  bool picks_ok[4] = {found[0], found[0] && found[1], found[0] && found[1] && found[2],
                      found[0] && found[1] && found[2] && found[3]};

  float eu_safe = eu > F(1.0e-6) ? eu : F(1.0);
  float ev_safe = ev > F(1.0e-6) ? ev : F(1.0);
  int face_type = ref_is_a ? 0 : 1;
  int prefix = (face_type << 24) | (ref_axis << 16) | (inc_axis << 8);

  // ---- edge contact ----
  int e_i = best_edge / 3, e_j = best_edge % 3;
  V3 ec_a, eh_a, ec_b, eh_b;
  support_edge(axa, hav, e_i, edge_n, &ec_a, &eh_a);
  support_edge(axb, hbv, e_j, vneg(edge_n), &ec_b, &eh_b);
  V3 p0 = vsub(vadd(pa, ec_a), eh_a);
  V3 p1 = vadd(vadd(pa, ec_a), eh_a);
  V3 q0 = vsub(vadd(pb, ec_b), eh_b);
  V3 q1 = vadd(vadd(pb, ec_b), eh_b);
  V3 d1 = vsub(p1, p0), d2 = vsub(q1, q0), r = vsub(p0, q0);
  float a = vdot(d1, d1), ee = vdot(d2, d2), f = vdot(d2, r), cc = vdot(d1, r), b = vdot(d1, d2);
  float denom = a * ee - b * b;
  float a_safe = a > F(1.0e-6) ? a : F(1.0);
  float e_safe = ee > F(1.0e-6) ? ee : F(1.0);
  bool den_ok = fabsf(denom) > F(1.0e-6);
  float s = den_ok ? clipf((b * f - cc * ee) / (den_ok ? denom : F(1.0)), F(0.0), F(1.0)) : F(0.0);
  float t = (b * s + f) / e_safe;
  s = t < F(0.0) ? clipf(-cc / a_safe, F(0.0), F(1.0))
                 : (t > F(1.0) ? clipf((b - cc) / a_safe, F(0.0), F(1.0)) : s);
  t = clipf(t, F(0.0), F(1.0));
  V3 edge_x_a = vadd(p0, vscale(d1, s));
  V3 edge_x_b = vadd(q0, vscale(d2, t));
  int edge_feature = (2 << 24) | (e_i << 8) | e_j;

  // ---- contact L & 3 ----
  out->normal = use_edge ? vneg(edge_n) : vneg(normal_ab);
  const int slot = L & 3;
  float fu = sel4f(slot, pu), fv = sel4f(slot, pv), fh = sel4f(slot, ph);
  V3 p_ref = vadd(face_center, vadd(vscale(u_ax, fu), vscale(v_ax, fv)));
  V3 p_inc = vadd(p_ref, vscale(n_ref, fh));
  V3 face_x_a = ref_is_a ? p_ref : p_inc;
  V3 face_x_b = ref_is_a ? p_inc : p_ref;
  int q_u = (int)clipf(floorf((fu / eu_safe + F(1.0)) * F(7.5)), F(0.0), F(15.0));
  int q_v = (int)clipf(floorf((fv / ev_safe + F(1.0)) * F(7.5)), F(0.0), F(15.0));
  int face_feat = prefix | (q_u << 4) | q_v;
  bool pok = slot == 0 ? picks_ok[0] : (slot == 1 ? picks_ok[1] : (slot == 2 ? picks_ok[2] : picks_ok[3]));
  V3 xa, xb;
  int feat;
  bool ok;
  if (slot == 0) {
    xa = use_edge ? edge_x_a : face_x_a;
    xb = use_edge ? edge_x_b : face_x_b;
    feat = use_edge ? edge_feature : face_feat;
    ok = use_edge || pok;
  } else {
    xa = face_x_a;
    xb = face_x_b;
    feat = face_feat;
    ok = pok && !use_edge;
  }
  ok = ok && !separated;
  out->x_a = xa;
  out->x_b = xb;
  out->feature = ok ? feat : -1;
  out->ok = ok;
  out->ok_bits = grp_ballot<W>(L < 4 && ok);
}


// ---------------------------------------------------------------------------
// Shared slot helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void contact_basis(V3 normal, V3* n, V3* t1, V3* t2) {
  *n = normalize_or(normal, v3(F(0.0), F(1.0), F(0.0)));
  bool cond = fabsf(n->x) >= fabsf(n->z);
  V3 t = cond ? v3(-n->y, n->x, F(0.0)) : v3(F(0.0), -n->z, n->y);
  *t1 = normalize_or(t, v3(F(1.0), F(0.0), F(0.0)));
  *t2 = normalize_or(vcross(*n, *t1), v3(F(0.0), F(0.0), F(1.0)));
}

__device__ __forceinline__ V3 half_at(const float* size, int i, int n) {
  return v3(size[i] * F(0.5), size[n + i] * F(0.5), size[2 * n + i] * F(0.5));
}

// Pair constants (pair_constants): friction and the normal-cap mass scale.
__device__ __forceinline__ void pair_consts(const Bodies& b, int i, int idx, float* mu, float* mass_scale) {
  *mu = sqrtf(b.friction[i] * b.friction[idx]);
  float inv_sum = b.inv_mass[i] + b.inv_mass[idx];
  *mass_scale = inv_sum > F(1.0e-6) ? F(1.0) / fmaxf(inv_sum, F(1.0e-6)) : F(1.0);
}

// Row math of one contact (eval_rows): C, bounds and projected lambda of its
// three rows, and the new stick latch.
struct Rows3 {
  float C[3], fmin[3], fmax[3], lam[3];
  bool stick;
};

__device__ __forceinline__ Rows3 eval_rows3(float sep, float slip1, float slip2, float c0n, float c0t1,
                                            float c0t2, const float* lam, const float* pen, bool stick,
                                            bool slot_ok, float mu, float cap, float bias, const KParams& p) {
  Rows3 r;
  float c_n = (sep - p.normal_contact_margin) + bias * c0n;
  float c_t1 = slip1 + bias * c0t1;
  float c_t2 = slip2 + bias * c0t2;
  float lam_n = lam[0];
  float warm_mag = fabsf(fminf(lam_n, F(0.0)));
  float trial = pen[0] * c_n + lam_n;
  float trial_mag = fabsf(fminf(trial, F(0.0)));
  float normal_mag = fminf(fmaxf(warm_mag, trial_mag), cap);
  float mu_s = stick ? mu : mu * F(0.9);
  float limit = mu_s * normal_mag;
  float lt1 = lam[1], lt2 = lam[2];
  float tan_mag = sqrtf(lt1 * lt1 + lt2 * lt2);
  float scale = ((tan_mag > limit) && (tan_mag > F(1.0e-8))) ? limit / fmaxf(tan_mag, F(1.0e-8)) : F(1.0);
  lt1 = lt1 * scale;
  lt2 = lt2 * scale;
  float slip_sq = c_t1 * c_t1 + c_t2 * c_t2;
  float tan_sq = lt1 * lt1 + lt2 * lt2;
  r.stick = (slip_sq <= p.stick_thresh_sq) && (tan_sq <= limit * limit + F(1.0e-8)) && slot_ok;
  r.C[0] = c_n; r.C[1] = c_t1; r.C[2] = c_t2;
  r.fmin[0] = -cap; r.fmax[0] = F(0.0);
  r.fmin[1] = -limit; r.fmax[1] = limit;
  r.fmin[2] = -limit; r.fmax[2] = limit;
  r.lam[0] = lam_n; r.lam[1] = lt1; r.lam[2] = lt2;
  return r;
}

// ---------------------------------------------------------------------------
// Phase 2a: symmetric filter + ordered precull, one warp per body and one
// lane per candidate slot (in chunks of 32 slots).  Each lane runs the
// plain version's statements for its slot; the ordered compaction puts a
// kept slot at the count of kept slots before it (the warp's running count
// plus the kept lanes below it in its chunk), the position the serial
// counter gives.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(BLOCK) k_filter_cull(Dims dm, const int* nb, const int* key, const int* thr,
                                                       Bodies b, Work w, KParams p) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (i >= dm.n) return;   // whole warps
  const int n = dm.n, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const bool precull = dm.dc < dm.d;
  V3 pos = ld3(b.pos, i, n);
  Q4 q = ld4(b.quat, i, n);
  V3 own_ax[3];
  qaxes(q, own_ax);
  V3 oh = half_at(b.size, i, n);
  float own_half[3] = {oh.x, oh.y, oh.z};
  int kept = 0, run = 0;
  for (int d0 = 0; d0 < dm.d; d0 += 32) {
    const int d = d0 + lane;
    bool keep = false, keep2 = false;
    int filt = -1;
    if (d < dm.d) {
      int nbv = nb[d * n + i];
      bool valid = nbv >= 0;
      int idx = valid ? nbv : 0;
      int k = key[d * n + i];
      int qd = k / n;   // keys are non-negative: floor division
      int key_rev = qd * n + i;
      bool kept_me = key_rev <= thr[idx];
      bool partner_static = (b.inv_mass[idx] > F(0.0) ? F(1.0) : F(0.0)) < F(0.5);
      keep = valid && (kept_me || partner_static);
      if (w.keptmask) w.keptmask[d * n + i] = keep ? F(1.0) : F(0.0);
      filt = keep ? nbv : -1;
      if (!precull) {
        w.nbc[d * n + i] = filt;
      } else {
        // 6-face-axis separation (precull_near): best over own and partner axes.
        bool v2 = filt >= 0;
        int j = v2 ? filt : 0;
        V3 pp = ld3(b.pos, j, n);
        V3 par_ax[3];
        qaxes(ld4(b.quat, j, n), par_ax);
        V3 ph = half_at(b.size, j, n);
        float par_half[3] = {ph.x, ph.y, ph.z};
        V3 delta = vsub(pp, pos);
        float best = F(-1.0e9);
        for (int a = 0; a < 6; ++a) {
          V3 nv = a < 3 ? own_ax[a] : par_ax[a - 3];
          float proj_own = own_half[0] * fabsf(own_ax[0].x * nv.x + own_ax[0].y * nv.y + own_ax[0].z * nv.z)
                         + own_half[1] * fabsf(own_ax[1].x * nv.x + own_ax[1].y * nv.y + own_ax[1].z * nv.z)
                         + own_half[2] * fabsf(own_ax[2].x * nv.x + own_ax[2].y * nv.y + own_ax[2].z * nv.z);
          float proj_par = par_half[0] * fabsf(par_ax[0].x * nv.x + par_ax[0].y * nv.y + par_ax[0].z * nv.z)
                         + par_half[1] * fabsf(par_ax[1].x * nv.x + par_ax[1].y * nv.y + par_ax[1].z * nv.z)
                         + par_half[2] * fabsf(par_ax[2].x * nv.x + par_ax[2].y * nv.y + par_ax[2].z * nv.z);
          float sep = fabsf(delta.x * nv.x + delta.y * nv.y + delta.z * nv.z) - proj_own - proj_par;
          best = max_nan(best, sep);  // torch.maximum: a NaN separation culls the slot
        }
        keep2 = v2 && (best <= p.precull_margin);
      }
    }
    kept += __popc(__ballot_sync(FULL_MASK, keep));
    if (precull) {
      const unsigned kept2 = __ballot_sync(FULL_MASK, keep2);
      const int at = run + __popc(kept2 & below);
      if (keep2 && at < dm.dc) w.nbc[at * n + i] = filt;
      run += __popc(kept2);
    }
  }
  if (precull)
    for (int t = run + lane; t < dm.dc; t += 32) w.nbc[t * n + i] = -1;
  if (lane == 0) {
    int dropped = precull && run > dm.dc ? run - dm.dc : 0;
    if (dropped) atomicAdd(&w.counters[1], dropped);
    if (kept) atomicAdd(&w.counters[0], kept);
  }
}

// ---------------------------------------------------------------------------
// Phase 2b: narrowphase + warmstart match + init, a group of W lanes per
// (slot, body).  The group runs the SAT and the clip (collide_pair),
// finds the body's old slot of the pair (lanes over the old slots, first hit),
// and lanes 0-3 then match, initialise and write one contact each; lane 0
// writes the slot's pair fields and, on the grid tier, its once-per-pair
// flag (ops/replicated.once_mask).  Invalid slots run the same arithmetic
// against body 0, as the plain version does.
// ---------------------------------------------------------------------------

template <int W>
__global__ void __launch_bounds__(BLOCK) k_collide(Dims dm, Cache old, Cache c, Bodies b, Work w, KParams p) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = dm.n, dc = dm.dc;
  const int grp = gid / W, L = grp_lane<W>();
  if (grp >= dc * n) return;   // whole warps: DC * N * W is a multiple of 32
  int t = grp / n, i = grp - t * n;
  int sl = t * n + i;          // slot offset in a (DC, N) leaf
  const int S = dc * n;        // stride between components of a slot leaf

  int nbv = w.nbc[sl];
  bool valid = nbv >= 0;
  int idx = valid ? nbv : 0;
  bool is_a = i < idx;
  V3 own_p = ld3(b.pos, i, n), oth_p = ld3(b.pos, idx, n);
  Q4 own_q = ld4(b.quat, i, n), oth_q = ld4(b.quat, idx, n);
  V3 own_h = half_at(b.size, i, n), oth_h = half_at(b.size, idx, n);
  V3 pa = is_a ? own_p : oth_p, pb = is_a ? oth_p : own_p;
  Q4 qa = is_a ? own_q : oth_q, qb = is_a ? oth_q : own_q;
  V3 ha = is_a ? own_h : oth_h, hb = is_a ? oth_h : own_h;

  PairLane g;
  collide_pair<W>(L, pa, qa, ha, pb, qb, hb, p.collision_margin, &g);
  const int s = L & 3;   // this lane's contact
  const bool slot_valid = g.ok && valid;
  const int feature_s = slot_valid ? g.feature : -1;
  int feature[4];
  bool slot_ok[4];
  for (int q = 0; q < 4; ++q) {
    feature[q] = grp_shfl<W>(feature_s, q);
    slot_ok[q] = ((g.ok_bits >> q) & 1u) && valid;
  }
  const int count = valid ? __popc(g.ok_bits) : 0;

  // ---- pair match against the body's own old slots: the first hit ----
  bool found = false;
  int m = 0;
  for (int dp0 = 0; dp0 < dc; dp0 += W) {
    int dp = dp0 + L;
    bool hit = dp < dc && valid && (old.other[dp * n + i] == nbv) && (old.count[dp * n + i] > 0);
    unsigned bits = grp_ballot<W>(hit);
    if (!found && bits) {
      found = true;
      m = dp0 + __ffs(bits) - 1;
    }
  }
  int ms = m * n + i;
  int o_count = found ? old.count[ms] : 0;
  int o_feature[4];
  for (int j = 0; j < 4; ++j) o_feature[j] = found ? old.feature[j * S + ms] : -1;
  V3 o_normal = v3(old.normal[ms], old.normal[S + ms], old.normal[2 * S + ms]);

  V3 new_n_unit = normalize_or(g.normal, v3(F(0.0), F(1.0), F(0.0)));
  V3 old_n_unit = normalize_or(o_normal, new_n_unit);
  float normal_dot = vdot(new_n_unit, old_n_unit);

  V3 n_unit, t1, t2;
  contact_basis(g.normal, &n_unit, &t1, &t2);

  // The greedy feature match of the four contacts in order; this lane keeps
  // the old contact its own contact takes (-1: none).
  bool used[4] = {false, false, false, false};
  int mine = -1;
  for (int q = 0; q < 4; ++q) {
    bool matched = false;
    for (int j = 0; j < 4; ++j) {
      bool o_ok = (j < o_count) && (o_feature[j] >= 0);
      bool elig = (o_feature[j] == feature[q]) && o_ok && !used[j] && slot_ok[q] && !matched && found;
      if (elig) {
        matched = true;
        used[j] = true;
        if (q == s) mine = j;
      }
    }
  }
  bool matched = mine >= 0, m_stick = false;
  V3 m_mid = v3(0.f, 0.f, 0.f), m_ra = v3(0.f, 0.f, 0.f), m_rb = v3(0.f, 0.f, 0.f);
  float m_lam[3] = {0.f, 0.f, 0.f}, m_pen[3] = {0.f, 0.f, 0.f};
  if (matched) {
    const int j = mine;
    m_ra = v3(old.r_a[(j * 3 + 0) * S + ms], old.r_a[(j * 3 + 1) * S + ms], old.r_a[(j * 3 + 2) * S + ms]);
    m_rb = v3(old.r_b[(j * 3 + 0) * S + ms], old.r_b[(j * 3 + 1) * S + ms], old.r_b[(j * 3 + 2) * S + ms]);
    m_mid = vscale(vadd(vadd(pa, qrotate(qa, m_ra)), vadd(pb, qrotate(qb, m_rb))), F(0.5));
    m_stick = old.stick_b != nullptr ? old.stick_b[j * S + ms] != 0 : old.stick[j * S + ms] > F(0.5);
    for (int k = 0; k < 3; ++k) {
      m_lam[k] = old.lam[(j * 3 + k) * S + ms];
      m_pen[k] = old.pen[(j * 3 + k) * S + ms];
    }
  }
  V3 new_ra = qrotate_inv(qa, vsub(g.x_a, pa));
  V3 new_rb = qrotate_inv(qb, vsub(g.x_b, pb));
  V3 new_mid = vscale(vadd(g.x_a, g.x_b), F(0.5));
  V3 dm_ = vsub(new_mid, m_mid);
  float drift2 = vdot(dm_, dm_);
  bool warm = matched && (normal_dot >= p.warmstart_normal_min_dot) && (drift2 <= p.ws2);
  float lam_i[3], pen_i[3];
  for (int k = 0; k < 3; ++k) {
    lam_i[k] = warm ? m_lam[k] : F(0.0);
    pen_i[k] = warm ? clipf(m_pen[k], p.penalty_min, p.manifold_penalty_cap) : p.penalty_min;
  }
  bool reuse = warm && m_stick && (normal_dot >= p.stick_normal_min_dot) && (drift2 <= p.st2);
  bool stick_i = m_stick && reuse;
  V3 r_a_i = reuse ? m_ra : new_ra;
  V3 r_b_i = reuse ? m_rb : new_rb;
  for (int k = 0; k < 3; ++k) {
    if (p.post_stabilize == F(0.0)) lam_i[k] = lam_i[k] * p.decay;
    pen_i[k] = clipf(pen_i[k] * p.gamma, p.penalty_min, p.penalty_max);
    lam_i[k] = slot_valid ? lam_i[k] : F(0.0);
    pen_i[k] = slot_valid ? pen_i[k] : F(0.0);
  }
  if (L < 4) {
    V3 p_a_i = vadd(pa, qrotate(qa, r_a_i));
    V3 p_b_i = vadd(pb, qrotate(qb, r_b_i));
    V3 delta = vsub(p_a_i, p_b_i);
    c.c0_n[s * S + sl] = vdot(delta, n_unit) - p.normal_contact_margin;
    c.c0_t1[s * S + sl] = vdot(delta, t1);
    c.c0_t2[s * S + sl] = vdot(delta, t2);
    c.r_a[(s * 3 + 0) * S + sl] = r_a_i.x;
    c.r_a[(s * 3 + 1) * S + sl] = r_a_i.y;
    c.r_a[(s * 3 + 2) * S + sl] = r_a_i.z;
    c.r_b[(s * 3 + 0) * S + sl] = r_b_i.x;
    c.r_b[(s * 3 + 1) * S + sl] = r_b_i.y;
    c.r_b[(s * 3 + 2) * S + sl] = r_b_i.z;
    c.stick[s * S + sl] = stick_i ? F(1.0) : F(0.0);
    c.feature[s * S + sl] = feature_s;
    for (int k = 0; k < 3; ++k) {
      c.lam[(s * 3 + k) * S + sl] = lam_i[k];
      c.pen[(s * 3 + k) * S + sl] = pen_i[k];
    }
  }
  if (L == 0) {
    int other = count > 0 ? nbv : -1;
    c.other[sl] = other;
    c.count[sl] = count;
    c.normal[sl] = n_unit.x;
    c.normal[S + sl] = n_unit.y;
    c.normal[2 * S + sl] = n_unit.z;
    if (w.once) {
      bool o_valid = other >= 0;
      int o_idx = o_valid ? other : 0;
      bool other_dyn = (b.inv_mass[o_idx] > F(0.0) ? F(1.0) : F(0.0)) > F(0.5);
      w.once[sl] = (o_valid && ((i < o_idx) || !other_dyn)) ? 1 : 0;
    }
  }
}

// Lanes of a slot's group.  A wider group shortens the pair's dependent
// chain (a lane of 16 tests 1 of the 15 axes), but every lane repeats the
// face frame, the edge contact and the warmstart match, so wide groups
// issue more instructions in all.  Measured on the card (PERF.md section
// 6): 4 lanes were the fastest at every shape but the smallest, where they
// tied.
constexpr int COLLIDE_LANES = 4;

cudaError_t launch_collide(Dims dm, const int* nb, const int* key, const int* thr, Cache old, Cache c, Bodies b,
                           Work w, KParams p, cudaStream_t st) {
  k_filter_cull<<<blocks_for(dm.n * 32), BLOCK, 0, st>>>(dm, nb, key, thr, b, w, p);
  k_collide<COLLIDE_LANES>
      <<<blocks_for(dm.dc * dm.n * COLLIDE_LANES), BLOCK, 0, st>>>(dm, old, c, b, w, p);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Phase 3: prediction, one thread per body.
// ---------------------------------------------------------------------------

__device__ __forceinline__ V3 san3(V3 v, V3 fallback, int* count) {
  bool fin = finite3(v);
  *count += fin ? 0 : 1;
  return fin ? v : fallback;
}

__global__ void __launch_bounds__(BLOCK) k_predict(Dims dm, Bodies b, Work w, KParams p) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= dm.n) return;
  const int n = dm.n;
  bool dyn = b.inv_mass[i] > F(0.0);
  float dynf = dyn ? F(1.0) : F(0.0);
  int san = 0;
  V3 pos0 = ld3(b.pos, i, n);
  Q4 quat0 = ld4(b.quat, i, n);
  V3 lv_in = ld3(b.lv, i, n), av_in = ld3(b.av, i, n), plv = ld3(b.plv, i, n);
  V3 zero = v3(0.f, 0.f, 0.f);
  V3 lv = san3(lv_in, zero, &san);
  float w_norm = sqrtf(vdot(av_in, av_in));
  float w_scale = w_norm > p.max_angular_speed ? p.max_angular_speed / fmaxf(w_norm, F(1.0e-12)) : F(1.0);
  V3 av = san3(vscale(av_in, w_scale), zero, &san);

  float lvv[3] = {lv.x, lv.y, lv.z}, p0[3] = {pos0.x, pos0.y, pos0.z}, plvv[3] = {plv.x, plv.y, plv.z};
  float ip[3];
  for (int k = 0; k < 3; ++k) ip[k] = dyn ? p0[k] + lvv[k] * p.dt + p.gdt2[k] : p0[k];
  Q4 oq = qmul(Q4{av.x, av.y, av.z, F(0.0)}, quat0);
  Q4 iq = q_normalize(Q4{quat0.x + oq.x * p.half_dt, quat0.y + oq.y * p.half_dt,
                         quat0.z + oq.z * p.half_dt, quat0.w + oq.w * p.half_dt});
  iq = dyn ? iq : quat0;

  float aw = F(0.0);
  if (p.has_gravity != F(0.0)) {
    float proj = (lvv[0] - plvv[0]) / p.dt * p.ghat[0];
    proj = proj + (lvv[1] - plvv[1]) / p.dt * p.ghat[1];
    proj = proj + (lvv[2] - plvv[2]) / p.dt * p.ghat[2];
    aw = clipf(proj / p.g_len, F(0.0), F(1.0));
    aw = isfinite(aw) ? aw : F(0.0);
  }
  V3 ps;
  float psv[3];
  for (int k = 0; k < 3; ++k) psv[k] = p0[k] + (lvv[k] * p.dt + p.grav[k] * (aw * p.dt * p.dt)) * dynf;
  ps = san3(v3(psv[0], psv[1], psv[2]), pos0, &san);

  st3(w.pos, i, n, ps);
  st4(w.quat, i, n, iq);
  st3(w.ip, i, n, v3(ip[0], ip[1], ip[2]));
  st4(w.iq, i, n, iq);
  st3(w.plv_out, i, n, dyn ? lv : plv);
  st3(w.pav_out, i, n, dyn ? av : av_in);
  if (san) atomicAdd(&w.counters[2], san);
}

// ---------------------------------------------------------------------------
// Geometry at the current working poses (geometry_pose), per contact of a
// slot: rw_a, rw_b, sep, slip1, slip2.
// ---------------------------------------------------------------------------

// Working poses are rewritten by other thread blocks between the phases of
// a sweep, so they are read through L2 (ld.global.cg), never through a
// block's L1 or the read-only path.
__device__ __forceinline__ V3 ld3cg(const float* p, int i, int n) {
  return v3(__ldcg(p + i), __ldcg(p + n + i), __ldcg(p + 2 * n + i));
}
__device__ __forceinline__ Q4 ld4cg(const float* p, int i, int n) {
  return Q4{__ldcg(p + i), __ldcg(p + n + i), __ldcg(p + 2 * n + i), __ldcg(p + 3 * n + i)};
}

// The poses of a slot's pair in its canonical A/B frame.  A partner in the
// slot's own logical block of w.blk bodies is read at its working pose, any
// other at the launch-start snapshot.
struct PairPose {
  V3 pa, pb;
  Q4 qa, qb;
};

__device__ __forceinline__ PairPose pair_pose(const Work& w, int i, int idx, bool is_a, int n) {
  RACE_DELAY();
  bool same_block = (idx / w.blk) == (i / w.blk);
  const float* pp = same_block ? w.pos : w.snap_pos;
  const float* pq = same_block ? w.quat : w.snap_quat;
  V3 own_p = ld3cg(w.pos, i, n), oth_p = ld3cg(pp, idx, n);
  Q4 own_q = ld4cg(w.quat, i, n), oth_q = ld4cg(pq, idx, n);
  PairPose pr;
  pr.pa = is_a ? own_p : oth_p;
  pr.pb = is_a ? oth_p : own_p;
  pr.qa = is_a ? own_q : oth_q;
  pr.qb = is_a ? oth_q : own_q;
  return pr;
}

struct ContactGeom {
  V3 rw_a, rw_b;
  float sep, slip1, slip2;
};

// Geometry of contact s of slot sl, stored to w.geom as it is computed.
__device__ __forceinline__ ContactGeom contact_geometry(const Cache& c, float* g, const PairPose& pr, int s,
                                                        int sl, int S, V3 nu, V3 t1, V3 t2) {
  ContactGeom gm;
  gm.rw_a = qrotate(pr.qa, v3(c.r_a[(s * 3) * S + sl], c.r_a[(s * 3 + 1) * S + sl], c.r_a[(s * 3 + 2) * S + sl]));
  gm.rw_b = qrotate(pr.qb, v3(c.r_b[(s * 3) * S + sl], c.r_b[(s * 3 + 1) * S + sl], c.r_b[(s * 3 + 2) * S + sl]));
  V3 delta = vsub(vadd(pr.pa, gm.rw_a), vadd(pr.pb, gm.rw_b));
  gm.sep = vdot(delta, nu);
  gm.slip1 = vdot(delta, t1);
  gm.slip2 = vdot(delta, t2);
  g[(s * 3 + 0) * S + sl] = gm.rw_a.x;
  g[(s * 3 + 1) * S + sl] = gm.rw_a.y;
  g[(s * 3 + 2) * S + sl] = gm.rw_a.z;
  g[(12 + s * 3 + 0) * S + sl] = gm.rw_b.x;
  g[(12 + s * 3 + 1) * S + sl] = gm.rw_b.y;
  g[(12 + s * 3 + 2) * S + sl] = gm.rw_b.z;
  g[(24 + s) * S + sl] = gm.sep;
  g[(28 + s) * S + sl] = gm.slip1;
  g[(32 + s) * S + sl] = gm.slip2;
  return gm;
}

// What the passes over slot (t, i) share and no sweep changes: the partner,
// the contact count, the pair constants and the contact basis.
struct SlotCtx {
  int sl, idx, count;
  bool valid, is_a;
  float mu, cap;
  V3 basis[3];
};

__device__ __forceinline__ SlotCtx slot_ctx(const Dims& dm, const Cache& c, const Bodies& b, const KParams& p,
                                            int i, int t) {
  const int n = dm.n, S = dm.dc * dm.n;
  SlotCtx x;
  x.sl = t * n + i;
  int other = c.other[x.sl];
  x.valid = other >= 0;
  x.idx = x.valid ? other : 0;
  x.is_a = i < x.idx;
  x.count = c.count[x.sl];
  float mass_scale;
  pair_consts(b, i, x.idx, &x.mu, &mass_scale);
  x.cap = p.normal_force_cap * mass_scale;
  contact_basis(v3(c.normal[x.sl], c.normal[S + x.sl], c.normal[2 * S + x.sl]), &x.basis[0], &x.basis[1],
                &x.basis[2]);
  return x;
}

// Geometry of slot (t, i) at the working poses, to w.geom.
__device__ __forceinline__ void geom_slot(const Dims& dm, const Cache& c, const Work& w, int i, int t) {
  const int n = dm.n, S = dm.dc * dm.n, sl = t * n + i;
  int other = c.other[sl];
  int idx = other >= 0 ? other : 0;
  V3 nu, t1, t2;
  contact_basis(v3(c.normal[sl], c.normal[S + sl], c.normal[2 * S + sl]), &nu, &t1, &t2);
  PairPose pr = pair_pose(w, i, idx, i < idx, n);
  for (int s = 0; s < 4; ++s) contact_geometry(c, w.geom, pr, s, sl, S, nu, t1, t2);
}

__global__ void __launch_bounds__(BLOCK) k_geom(Dims dm, Cache c, Work w) {
  int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= dm.dc * dm.n) return;
  geom_slot(dm, c, w, gid % dm.n, gid / dm.n);
}

// ---------------------------------------------------------------------------
// Phase 4a: primal pass.  A thread block owns a tile of bodies: one thread
// per (slot, body) writes the slot's partial sums to shared memory, the
// block folds them in slot order, then one thread per body solves.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void world_inertia(Q4 q, V3 d, float out[6]) {
  V3 ax[3];
  qaxes(q, ax);
  float a[3][3] = {{ax[0].x, ax[0].y, ax[0].z}, {ax[1].x, ax[1].y, ax[1].z}, {ax[2].x, ax[2].y, ax[2].z}};
  float dd[3] = {d.x, d.y, d.z};
  const int ij[6][2] = {{0, 0}, {0, 1}, {0, 2}, {1, 1}, {1, 2}, {2, 2}};
  for (int k = 0; k < 6; ++k) {
    int ii = ij[k][0], jj = ij[k][1];
    out[k] = dd[0] * a[0][ii] * a[0][jj] + dd[1] * a[1][ii] * a[1][jj] + dd[2] * a[2][ii] * a[2][jj];
  }
}

// Component-form 3x3 LDL^T solve (maths.solve3_sym_cm).
static __device__ void solve3_sym(const float a[6], const float bv[3], float x[3]) {
  const float EPS = F(1.1920929e-07);
  float xx = a[0], xy = a[1], xz = a[2], yy = a[3], yz = a[4], zz = a[5];
  bool bad0 = fabsf(xx) < EPS;
  float d0 = bad0 ? F(1.0) : xx;
  float l10 = xy / d0;
  float l20 = xz / d0;
  float d1_raw = yy - xy * l10;
  bool bad1 = fabsf(d1_raw) < EPS;
  float d1 = bad1 ? F(1.0) : d1_raw;
  float l21 = (yz - xz * l10) / d1;
  float d2_raw = zz - xz * l20 - (yz - xz * l10) * l21;
  bool bad2 = fabsf(d2_raw) < EPS;
  float d2 = bad2 ? F(1.0) : d2_raw;
  float y0 = bv[0];
  float y1 = bv[1] - l10 * y0;
  float y2 = bv[2] - l20 * y0 - l21 * y1;
  float z0 = y0 / d0, z1 = y1 / d1, z2 = y2 / d2;
  float x2 = z2;
  float x1 = z1 - l21 * x2;
  float x0 = z0 - l10 * x1 - l20 * x2;
  bool bad = bad0 || bad1 || bad2;
  x[0] = bad ? F(0.0) : x0;
  x[1] = bad ? F(0.0) : x1;
  x[2] = bad ? F(0.0) : x2;
}

// 6x6 Schur solve (maths.solve66_cm).
static __device__ void solve66(const float a_ll[6], const float a_la[9], const float a_aa[6], const float b_l[3],
                        const float b_a[3], float dl[3], float da[3]) {
  float cols[3][3];
  for (int j = 0; j < 3; ++j) {
    float col[3] = {a_la[0 + j], a_la[3 + j], a_la[6 + j]};
    solve3_sym(a_ll, col, cols[j]);
  }
  float x0[3];
  solve3_sym(a_ll, b_l, x0);
  const int ij[6][2] = {{0, 0}, {0, 1}, {0, 2}, {1, 1}, {1, 2}, {2, 2}};
  float schur[6];
  for (int k = 0; k < 6; ++k) {
    int i = ij[k][0], j = ij[k][1];
    float s = a_aa[k];
    for (int m = 0; m < 3; ++m) s = s - a_la[m * 3 + i] * cols[j][m];
    schur[k] = s;
  }
  float rhs_s[3];
  for (int i = 0; i < 3; ++i) {
    float s = b_a[i];
    for (int m = 0; m < 3; ++m) s = s - a_la[m * 3 + i] * x0[m];
    rhs_s[i] = s;
  }
  solve3_sym(schur, rhs_s, da);
  for (int k = 0; k < 3; ++k) dl[k] = x0[k] - (cols[0][k] * da[0] + cols[1][k] * da[1] + cols[2][k] * da[2]);
}

// Number of partial sums of a slot: F (3), T (3) and the 24 Hessian terms.
#define N_PART 30

// Contact terms of slot (t, i) for one sweep, at the sweep-start geometry in
// w.geom: the rows and primal force of its four contacts, their force and
// torque sums (components 0-5 of the slot's partials) and, on a rebuild, its
// 24 Hessian terms summed over the 12 rows (components 6-29).  ``x``: the
// slot's constants (slot_ctx).  ``part``
// points at the slot's cell of the block's partials; component q lies at
// part[q * pstride].  The projected lambdas and the new stick latches go
// back to the cache for the dual pass.  Sums run over contacts, then rows, in
// order, starting from the first term (the plain version's order).
__device__ __forceinline__ void primal_slot(const Dims& dm, const Cache& c, const Bodies& b, const Work& w,
                                            const KParams& p, const SlotCtx& x, int rebuild, float bias, int i,
                                            float* part, int pstride) {
  const int n = dm.n, S = dm.dc * dm.n, sl = x.sl, count = x.count;
  const bool valid = x.valid, is_a = x.is_a;
  const float sign = is_a ? F(1.0) : F(-1.0), mu = x.mu, cap = x.cap;
  const V3* basis = x.basis;
  float iiw[6];
  if (rebuild) world_inertia(ld4(w.quat, i, n), ld3(b.inv_inertia, i, n), iiw);
  const float* g = w.geom;
  float* md = part + 6 * pstride;

  float Fd[6];     // F (3) and T (3) of this slot, summed over its contacts
  for (int s = 0; s < 4; ++s) {
    bool slot_ok = (s < count) && valid;
    float lam[3], pen[3];
    for (int k = 0; k < 3; ++k) {
      lam[k] = c.lam[(s * 3 + k) * S + sl];
      pen[k] = c.pen[(s * 3 + k) * S + sl];
    }
    bool stick = c.stick[s * S + sl] > F(0.5);
    Rows3 r = eval_rows3(g[(24 + s) * S + sl], g[(28 + s) * S + sl], g[(32 + s) * S + sl], c.c0_n[s * S + sl],
                         c.c0_t1[s * S + sl], c.c0_t2[s * S + sl], lam, pen, stick, slot_ok, mu, cap, bias, p);
    float f[3];
    for (int k = 0; k < 3; ++k) {
      f[k] = slot_ok ? clipf(pen[k] * r.C[k] + r.lam[k], r.fmin[k], r.fmax[k]) : F(0.0);
      // The dual pass reads the projected lambda and the new latch.
      c.lam[(s * 3 + k) * S + sl] = r.lam[k];
    }
    c.stick[s * S + sl] = r.stick ? F(1.0) : F(0.0);

    const int ro = is_a ? 0 : 12;
    V3 rw = v3(g[(ro + s * 3) * S + sl], g[(ro + s * 3 + 1) * S + sl], g[(ro + s * 3 + 2) * S + sl]);
    V3 fv = v3(basis[0].x * f[0] + basis[1].x * f[1] + basis[2].x * f[2],
               basis[0].y * f[0] + basis[1].y * f[1] + basis[2].y * f[2],
               basis[0].z * f[0] + basis[1].z * f[1] + basis[2].z * f[2]);
    V3 tv = vcross(rw, fv);
    float contrib[6] = {sign * fv.x, sign * fv.y, sign * fv.z, sign * tv.x, sign * tv.y, sign * tv.z};
    for (int k = 0; k < 6; ++k) Fd[k] = s == 0 ? contrib[k] : Fd[k] + contrib[k];

    if (rebuild) {
      float okf = slot_ok ? F(1.0) : F(0.0);
      for (int k = 0; k < 3; ++k) {
        V3 bb = basis[k];
        float pe = pen[k] * okf;
        V3 cr = vcross(rw, bb);
        float bv[3] = {bb.x, bb.y, bb.z}, cv[3] = {cr.x, cr.y, cr.z};
        float term[24];
        term[0] = pe * bv[0] * bv[0];
        term[1] = pe * bv[0] * bv[1];
        term[2] = pe * bv[0] * bv[2];
        term[3] = pe * bv[1] * bv[1];
        term[4] = pe * bv[1] * bv[2];
        term[5] = pe * bv[2] * bv[2];
        for (int ii = 0; ii < 3; ++ii)
          for (int jj = 0; jj < 3; ++jj) term[6 + ii * 3 + jj] = pe * bv[ii] * cv[jj];
        term[15] = pe * cv[0] * cv[0];
        term[16] = pe * cv[0] * cv[1];
        term[17] = pe * cv[0] * cv[2];
        term[18] = pe * cv[1] * cv[1];
        term[19] = pe * cv[1] * cv[2];
        term[20] = pe * cv[2] * cv[2];
        V3 ic = v3(iiw[0] * cv[0] + iiw[1] * cv[1] + iiw[2] * cv[2],
                   iiw[1] * cv[0] + iiw[3] * cv[1] + iiw[4] * cv[2],
                   iiw[2] * cv[0] + iiw[4] * cv[1] + iiw[5] * cv[2]);
        V3 gcr = vcross(cr, ic);
        float af = fabsf(f[k]);
        term[21] = fabsf(gcr.x) * af;
        term[22] = fabsf(gcr.y) * af;
        term[23] = fabsf(gcr.z) * af;
        // The running sums of the 24 terms live in the slot's shared-memory
        // cell, not in registers.
        bool first = (s == 0) && (k == 0);
        for (int q = 0; q < 24; ++q) md[q * pstride] = first ? term[q] : md[q * pstride] + term[q];
      }
    }
  }
  for (int k = 0; k < 6; ++k) part[k * pstride] = Fd[k];
}

// How a thread block of the tiled kernels divides its work.
struct TileIdx {
  int tile, lanes, bl, lane, base;   // base: first body of the block's tile
};

__device__ __forceinline__ TileIdx tile_index(int tile) {
  TileIdx ti;
  ti.tile = tile;
  ti.lanes = blockDim.x / tile;
  ti.bl = threadIdx.x % tile;
  ti.lane = threadIdx.x / tile;
  ti.base = blockIdx.x * tile;
  return ti;
}

// The primal pass's slot half for the block's tile: every (slot, body)
// partial to shared memory (``sh``: N_PART x DC x tile floats, body fastest),
// then the fold over slots, left to right from slot 0 as cm.dsum folds: F
// and T to ``fold`` (6 x tile floats, after the partials) and, on a rebuild,
// the Hessian terms to w.mat.  ``own``: the constants of the thread's one
// slot where it has exactly one, else null.  Ends with the block
// synchronised.
__device__ __forceinline__ void primal_tile(const Dims& dm, const Cache& c, const Bodies& b, const Work& w,
                                            const KParams& p, int rebuild, float alpha_cur, const TileIdx& ti,
                                            float* sh, float* fold, const SlotCtx* own) {
  const int dc = dm.dc, tile = ti.tile, pstride = dc * tile, i = ti.base + ti.bl;
  const float bias = clipf(F(1.0) - alpha_cur, F(0.0), F(1.0));
  if (own) {
    // One slot per thread, its constants kept by the caller.
    primal_slot(dm, c, b, w, p, *own, rebuild, bias, i, sh + ti.lane * tile + ti.bl, pstride);
  } else {
    for (int t = ti.lane; t < dc; t += ti.lanes)
      primal_slot(dm, c, b, w, p, slot_ctx(dm, c, b, p, i, t), rebuild, bias, i, sh + t * tile + ti.bl, pstride);
  }
  __syncthreads();
  const int n_comp = rebuild ? N_PART : 6;
  for (int k = threadIdx.x; k < n_comp * tile; k += blockDim.x) {
    int q = k / tile, bl = k - q * tile;
    const float* src = sh + q * pstride + bl;
    float acc = src[0];
    for (int t = 1; t < dc; ++t) acc = acc + src[t * tile];
    if (q < 6) fold[q * tile + bl] = acc;
    else w.mat[(q - 6) * dm.n + ti.base + bl] = acc;
  }
  __syncthreads();
}

// One family of joint or spring rows summed over a body's slots: F (3), T
// (3), ll (6), la (9), aa (6), in that order.
#define ROW_TERMS 27
struct RowAcc {
  float v[ROW_TERMS];
};

// The primal solve of body i at (pos, quat): inertia and contact terms
// (F3, T3, M), then each row family's terms in order (_kernel_b_math
// 487-528), then solve66.
__device__ __forceinline__ void body_solve(const Bodies& b, const Work& w, const KParams& p, int i, int n, V3 pos,
                                           Q4 quat, const float F3[3], const float T3[3], const float M[24],
                                           const RowAcc* acc, int n_acc, float dl[3], float da[3]) {
  const float* m_ll = M;
  const float* m_la = M + 6;
  const float* m_aa = M + 15;
  const float* gyro = M + 21;

  float iw[6];
  world_inertia(quat, ld3(b.inertia, i, n), iw);
  V3 ip = ld3(w.ip, i, n);
  Q4 iq = ld4(w.iq, i, n);
  float mass = b.mass[i];
  float posv[3] = {pos.x, pos.y, pos.z}, ipv[3] = {ip.x, ip.y, ip.z};
  float rhs_l[3];
  for (int k = 0; k < 3; ++k) rhs_l[k] = mass * (posv[k] - ipv[k]) * p.inv_dt2 + F3[k];
  Q4 q_err = qmul(quat, Q4{-iq.x, -iq.y, -iq.z, iq.w});
  float sgn = q_err.w < F(0.0) ? F(-2.0) : F(2.0);
  float rot[3] = {q_err.x * sgn, q_err.y * sgn, q_err.z * sgn};
  float rhs_a[3] = {
      (iw[0] * rot[0] + iw[1] * rot[1] + iw[2] * rot[2]) * p.inv_dt2 + T3[0],
      (iw[1] * rot[0] + iw[3] * rot[1] + iw[4] * rot[2]) * p.inv_dt2 + T3[1],
      (iw[2] * rot[0] + iw[4] * rot[1] + iw[5] * rot[2]) * p.inv_dt2 + T3[2]};
  float m_dt2 = mass * p.inv_dt2;
  float a_ll[6] = {m_ll[0] + m_dt2, m_ll[1], m_ll[2], m_ll[3] + m_dt2, m_ll[4], m_ll[5] + m_dt2};
  float a_la[9];
  for (int k = 0; k < 9; ++k) a_la[k] = m_la[k];
  float a_aa[6] = {m_aa[0] + iw[0] * p.inv_dt2 + gyro[0], m_aa[1] + iw[1] * p.inv_dt2,
                   m_aa[2] + iw[2] * p.inv_dt2, m_aa[3] + iw[3] * p.inv_dt2 + gyro[1],
                   m_aa[4] + iw[4] * p.inv_dt2, m_aa[5] + iw[5] * p.inv_dt2 + gyro[2]};
  for (int a = 0; a < n_acc; ++a) {
    const float* v = acc[a].v;
    for (int k = 0; k < 3; ++k) {
      rhs_l[k] = rhs_l[k] + v[k];
      rhs_a[k] = rhs_a[k] + v[3 + k];
    }
    for (int k = 0; k < 6; ++k) {
      a_ll[k] = a_ll[k] + v[6 + k];
      a_aa[k] = a_aa[k] + v[21 + k];
    }
    for (int k = 0; k < 9; ++k) a_la[k] = a_la[k] + v[12 + k];
  }
  solve66(a_ll, a_la, a_aa, rhs_l, rhs_a, dl, da);
}

// The relaxed pose update; a body with applyb false keeps its quat, and its
// position moves by relax * dl * applyf (0 for applyf 0 and finite dl).
__device__ __forceinline__ void pose_update(V3 pos, Q4 quat, const float dl[3], const float da[3], float applyf,
                                            bool applyb, const KParams& p, V3* out_p, Q4* out_q) {
  const float relax = p.relaxation;
  *out_p = v3(pos.x - relax * dl[0] * applyf, pos.y - relax * dl[1] * applyf, pos.z - relax * dl[2] * applyf);
  Q4 dq = qmul(Q4{da[0] * relax, da[1] * relax, da[2] * relax, F(0.0)}, quat);
  Q4 nq = q_normalize(Q4{quat.x - F(0.5) * dq.x, quat.y - F(0.5) * dq.y, quat.z - F(0.5) * dq.z,
                         quat.w - F(0.5) * dq.w});
  *out_q = applyb ? nq : quat;
}

// The primal pass's body half: the solve and the relaxed pose update of
// the tile's bodies, one thread each, from the folded F / T and w.mat.
__device__ __forceinline__ void primal_bodies(const Dims& dm, const Bodies& b, const Work& w, const KParams& p,
                                              const TileIdx& ti, const float* fold) {
  if (threadIdx.x >= ti.tile) return;
  const int n = dm.n, i = ti.base + threadIdx.x;
  bool dyn = b.inv_mass[i] > F(0.0);
  float dynf = dyn ? F(1.0) : F(0.0);
  V3 pos = ld3(w.pos, i, n);
  Q4 quat = ld4(w.quat, i, n);
  float F3[3], T3[3], M[24];
  for (int k = 0; k < 3; ++k) {
    F3[k] = fold[k * ti.tile + threadIdx.x];
    T3[k] = fold[(3 + k) * ti.tile + threadIdx.x];
  }
  for (int q = 0; q < 24; ++q) M[q] = w.mat[q * n + i];
  float dl[3], da[3];
  body_solve(b, w, p, i, n, pos, quat, F3, T3, M, nullptr, 0, dl, da);
  V3 new_pos;
  Q4 nq;
  pose_update(pos, quat, dl, da, dynf, dyn, p, &new_pos, &nq);
  RACE_DELAY();
  st3(w.pos, i, n, new_pos);
  st4(w.quat, i, n, nq);
}

// Contact-only sweep, primal half, one launch: N / tile blocks.  The tiled
// kernels are compiled for several block-size ceilings (MAXT), so a shape
// whose blocks are smaller gets more registers per thread; the launchers
// pick the smallest ceiling that holds the plan's threads.
template <int MAXT>
__global__ void __launch_bounds__(MAXT) k_primal(Dims dm, Cache c, Bodies b, Work w, KParams p, int tile,
                                                 int rebuild, float alpha_cur) {
  extern __shared__ float sh[];
  TileIdx ti = tile_index(tile);
  float* fold = sh + N_PART * dm.dc * tile;
  primal_tile(dm, c, b, w, p, rebuild, alpha_cur, ti, sh, fold, nullptr);
  primal_bodies(dm, b, w, p, ti, fold);
}

// ---------------------------------------------------------------------------
// Phase 4b: geometry at the new poses + dual update, one thread per slot.
// ---------------------------------------------------------------------------

// The cluster barrier in two halves, so that work between them hides the
// wait: every thread of the cluster arrives once and waits once per phase.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

#define BAR_WAIT_POSES 1    // wait for the logical block's new poses before reading them
#define BAR_POSES_READ 2    // signal that this thread has read the poses it needs

// Slot x: geometry at the new poses (to w.geom), then the dual update of its
// rows, contact by contact.  ``bar`` (the cluster-resident loop): the
// barrier halves around the pose reads, 0 elsewhere.
__device__ __forceinline__ void dual_slot(const Dims& dm, const Cache& c, const Work& w, const KParams& p,
                                          const SlotCtx& x, int do_dual, int ramp, float alpha_cur, int i,
                                          int bar) {
  const int n = dm.n, S = dm.dc * dm.n, sl = x.sl, count = x.count;
  const float bias = clipf(F(1.0) - alpha_cur, F(0.0), F(1.0));
  const bool valid = x.valid;
  const float mu = x.mu, cap = x.cap;
  const V3* basis = x.basis;
  if (bar & BAR_WAIT_POSES) cluster_wait();
  PairPose pr = pair_pose(w, i, x.idx, x.is_a, n);
  if (bar & BAR_POSES_READ) cluster_arrive();
  for (int s = 0; s < 4; ++s) {
    ContactGeom gm = contact_geometry(c, w.geom, pr, s, sl, S, basis[0], basis[1], basis[2]);
    bool slot_ok = (s < count) && valid;
    float lam[3], pen[3];
    for (int k = 0; k < 3; ++k) {
      lam[k] = c.lam[(s * 3 + k) * S + sl];
      pen[k] = c.pen[(s * 3 + k) * S + sl];
    }
    bool stick = c.stick[s * S + sl] > F(0.5);
    Rows3 r = eval_rows3(gm.sep, gm.slip1, gm.slip2, c.c0_n[s * S + sl], c.c0_t1[s * S + sl],
                         c.c0_t2[s * S + sl], lam, pen, stick, slot_ok, mu, cap, bias, p);
    for (int k = 0; k < 3; ++k) {
      float out_lam, out_pen = pen[k];
      if (do_dual) {
        V3 ja_a = vcross(gm.rw_a, basis[k]);
        V3 ja_b = vcross(gm.rw_b, basis[k]);
        float ang_w = vdot(ja_a, ja_a) + vdot(ja_b, ja_b);
        float gain = (p.beta2 + p.beta_ang * ang_w) / (F(2.0) + ang_w + F(1.0e-8));
        float lam_r = clipf(pen[k] * r.C[k] + r.lam[k], r.fmin[k], r.fmax[k]);
        bool active = (lam_r > r.fmin[k]) && (lam_r < r.fmax[k]);
        float pe = active ? fminf(pen[k] + gain * fabsf(r.C[k]), p.manifold_penalty_cap) : pen[k];
        out_lam = slot_ok ? lam_r : F(0.0);
        if (ramp) out_pen = slot_ok ? pe : pen[k];
      } else {
        out_lam = r.lam[k];
      }
      c.lam[(s * 3 + k) * S + sl] = out_lam;
      c.pen[(s * 3 + k) * S + sl] = out_pen;
    }
    c.stick[s * S + sl] = r.stick ? F(1.0) : F(0.0);
  }
}

__global__ void __launch_bounds__(BLOCK) k_dual(Dims dm, Cache c, Bodies b, Work w, KParams p, int do_dual,
                                                int ramp, float alpha_cur) {
  int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= dm.dc * dm.n) return;
  int i = gid % dm.n;
  dual_slot(dm, c, w, p, slot_ctx(dm, c, b, p, i, gid / dm.n), do_dual, ramp, alpha_cur, i, 0);
}

// ---------------------------------------------------------------------------
// The cluster-resident sweep loop: one launch for all sweeps of ``ip``.
//
// One thread-block cluster per logical block of w.blk bodies (tile * cluster
// size); each block of the cluster keeps its tile of bodies through the
// loop.  Per sweep: the primal pass as in k_primal, a cluster barrier (every
// new pose of the logical block written), the dual pass of the tile's slots,
// a cluster barrier (every partner pose read before the next primal pass
// overwrites it).  Each barrier is split into its arrive and wait halves:
// a thread arrives as soon as its part is done (its pose written, its
// partner poses read) and waits only where it needs the others (before it
// reads partner poses, before it writes a pose), so the rest of the dual
// pass and the next primal pass's slot half run inside the second barrier.  A slot's geometry, lambdas, penalties and latches are
// written and read by the one thread that owns the slot, so only the poses
// cross threads: they stay in global memory (L2) and are read with
// ld.global.cg.  Partners outside the logical block are read at the
// launch-start snapshot, which no launch writes, so clusters never wait for
// each other.
// ---------------------------------------------------------------------------

template <int MAXT>
__global__ void __launch_bounds__(MAXT) k_sweeps(Dims dm, Cache c, Bodies b, Work w, KParams p, int tile,
                                                 IterPlan ip, int with_geom, Carry carry) {
  extern __shared__ float sh[];
  cg::cluster_group cluster = cg::this_cluster();
  TileIdx ti = tile_index(tile);
  const int n = dm.n, dc = dm.dc, S = dc * n, i = ti.base + ti.bl;
  if (carry.pos) {
    // The grid tier's launch-start state into the working buffers.
    if (threadIdx.x < tile) {
      st3(w.pos, i, n, ld3(carry.pos, i, n));
      st4(w.quat, i, n, ld4(carry.quat, i, n));
    }
    for (int t = ti.lane; t < dc; t += ti.lanes) {
      int sl = t * n + i;
      for (int r = 0; r < 12; ++r) {
        c.lam[r * S + sl] = carry.lam[r * S + sl];
        c.pen[r * S + sl] = carry.pen[r * S + sl];
      }
      for (int s = 0; s < 4; ++s) c.stick[s * S + sl] = carry.stick[s * S + sl];
    }
    cluster.sync();
  }
  if (with_geom)
    for (int t = ti.lane; t < dc; t += ti.lanes) geom_slot(dm, c, w, i, t);
  // A thread with exactly one slot keeps the slot's constants through the
  // loop where the block size leaves it the registers (above 768 threads a
  // thread has 64, and keeping them spills more than it saves); otherwise it
  // recomputes them per pass.
  const bool one = MAXT <= 768 && ti.lanes >= dc;
  float* fold = sh + N_PART * dc * tile;
  SlotCtx own;
  if (one) own = slot_ctx(dm, c, b, p, i, ti.lane);
  // The start geometry has read its partner poses.
  cluster_arrive();
  if (ip.n == 0) cluster_wait();
  for (int it = 0; it < ip.n; ++it) {
    primal_tile(dm, c, b, w, p, ip.rebuild[it], ip.alpha[it], ti, sh, fold, one ? &own : nullptr);
    // Every partner has read this body's old pose (for the start geometry
    // or in the previous sweep's dual pass) before the new one is written.
    cluster_wait();
    primal_bodies(dm, b, w, p, ti, fold);
    cluster_arrive();
    const bool more = it + 1 < ip.n;
    for (int t = ti.lane; t < dc; t += ti.lanes) {
      // The barrier halves go around the pose reads of the thread's first
      // and last slot.
      int bar = (t == ti.lane ? BAR_WAIT_POSES : 0) | (more && t + ti.lanes >= dc ? BAR_POSES_READ : 0);
      if (one) dual_slot(dm, c, w, p, own, ip.do_dual[it], ip.ramp[it], ip.alpha[it], i, bar);
      else dual_slot(dm, c, w, p, slot_ctx(dm, c, b, p, i, t), ip.do_dual[it], ip.ramp[it], ip.alpha[it], i, bar);
    }
  }
}

// ---------------------------------------------------------------------------
// Joint and spring rows (ops/joints.py, ops/springs.py): the branch of K1 for
// worlds with dj or ds > 0.
//
// Every slot is computed in the joint's own A/B frame (``side``, ``world``)
// from the same operands on both replicas, statement for statement as the
// plain version, so the two replicas of a joint stay bit-identical.  Sums
// over a body's DJ / DS slots run in slot order, as cm.dsum does.
// ---------------------------------------------------------------------------

struct JointRows {
  int dj, ds, n_colors;
  const int* j_other;      // (DJ, N)
  const int* j_world;
  const int* j_side;
  const float* j_anchor_a; // (3, DJ, N)
  const float* j_anchor_b;
  const float* j_rest;     // (4, DJ, N)
  const float* j_stiff_lin;  // (DJ, N)
  const float* j_stiff_ang;
  const float* j_rmotor;   // (6, DJ, N)
  const float* j_lam_in;   // (6, DJ, N) the step's input duals
  const float* j_pen_in;
  const int* color;        // (N)
  const int* s_other;      // (DS, N)
  const int* s_world;
  const int* s_side;
  const float* s_anchor_a; // (3, DS, N)
  const float* s_anchor_b;
  const float* s_rrest;    // (DS, N)
  const float* s_rstiff;
  const float* s_pen_in;
  float* j_lam;            // (6, DJ, N) carried duals (outputs)
  float* j_pen;
  float* s_pen;            // (DS, N) the step's spring penalty (output)
};

struct JointGeom {
  float C[6];
  V3 rw_a, rw_b, rw_own;
  bool valid, is_a, is_world;
};

// joint_geometry for slot sl = t * N + i (S = DJ * N) at the poses P / Q,
// read through L2: inside the resident loop other thread blocks rewrite
// them.
__device__ __forceinline__ JointGeom joint_geometry(const JointRows& jr, int sl, int S, int i, int n,
                                                    const float* P, const float* Q) {
  JointGeom g;
  int other = jr.j_other[sl];
  g.valid = other >= 0;
  int idx = g.valid ? other : 0;
  g.is_a = jr.j_side[sl] > 0;
  g.is_world = jr.j_world[sl] > 0;
  V3 own_p = ld3cg(P, i, n), oth_p = ld3cg(P, idx, n);
  Q4 own_q = ld4cg(Q, i, n), oth_q = ld4cg(Q, idx, n);
  V3 anchor_a = v3(jr.j_anchor_a[sl], jr.j_anchor_a[S + sl], jr.j_anchor_a[2 * S + sl]);
  V3 anchor_b = v3(jr.j_anchor_b[sl], jr.j_anchor_b[S + sl], jr.j_anchor_b[2 * S + sl]);
  Q4 rest = Q4{jr.j_rest[sl], jr.j_rest[S + sl], jr.j_rest[2 * S + sl], jr.j_rest[3 * S + sl]};
  V3 pa_body = g.is_a ? own_p : oth_p;
  Q4 qa_body = g.is_a ? own_q : oth_q;
  Q4 qa = g.is_world ? Q4{F(0.0), F(0.0), F(0.0), F(1.0)} : qa_body;
  g.rw_a = g.is_world ? v3(F(0.0), F(0.0), F(0.0)) : qrotate(qa, anchor_a);
  V3 p_a = g.is_world ? anchor_a : vadd(pa_body, g.rw_a);
  V3 pb_body = g.is_a ? oth_p : own_p;
  Q4 qb = g.is_a ? oth_q : own_q;
  g.rw_b = qrotate(qb, anchor_b);
  V3 p_b = vadd(pb_body, g.rw_b);
  V3 lin_c = vsub(p_a, p_b);
  Q4 q_rel = qmul(Q4{-qa.x, -qa.y, -qa.z, qa.w}, qb);
  Q4 dq = qmul(q_rel, Q4{-rest.x, -rest.y, -rest.z, rest.w});
  float c[6] = {lin_c.x, lin_c.y, lin_c.z, F(2.0) * dq.x, F(2.0) * dq.y, F(2.0) * dq.z};
  for (int r = 0; r < 6; ++r) g.C[r] = g.valid ? c[r] : F(0.0);
  g.rw_own = g.is_a ? g.rw_a : g.rw_b;
  return g;
}

__device__ __forceinline__ float joint_stiff(const JointRows& jr, int sl, int r) {
  return r < 3 ? jr.j_stiff_lin[sl] : jr.j_stiff_ang[sl];
}

// joint_force + joint_accumulate's terms of one slot, to out[q * os] for
// the ROW_TERMS terms q.
__device__ __forceinline__ void joint_slot_terms(const JointRows& jr, const JointGeom& g, int sl, int S,
                                                 float* out, int os) {
  float f[6], pen[6];
  for (int r = 0; r < 6; ++r) {
    float lam = jr.j_lam[r * S + sl];
    pen[r] = jr.j_pen[r * S + sl];
    bool hard = !isfinite(joint_stiff(jr, sl, r));
    float lam_warm = hard ? lam : F(0.0);
    float fr = pen[r] * g.C[r] + lam_warm + jr.j_rmotor[r * S + sl];
    f[r] = g.valid ? fr : F(0.0);
  }
  float sign = g.is_a ? F(1.0) : F(-1.0);
  float okf = g.valid ? F(1.0) : F(0.0);
  V3 rw = g.rw_own;
  V3 f_lin = v3(f[0] * okf, f[1] * okf, f[2] * okf);
  float f_ang[3] = {f[3] * okf, f[4] * okf, f[5] * okf};
  V3 tv = vcross(rw, f_lin);
  const float zero = F(0.0);
  float cc[3][3] = {{zero, rw.z, -rw.y}, {-rw.z, zero, rw.x}, {rw.y, -rw.x, zero}};
  float pp[6];
  for (int r = 0; r < 6; ++r) pp[r] = pen[r] * okf;
  float t[27];
  t[0] = sign * f_lin.x;
  t[1] = sign * f_lin.y;
  t[2] = sign * f_lin.z;
  t[3] = sign * (tv.x + f_ang[0]);
  t[4] = sign * (tv.y + f_ang[1]);
  t[5] = sign * (tv.z + f_ang[2]);
  float ll[6] = {pp[0], zero, zero, pp[1], zero, pp[2]};
  for (int k = 0; k < 6; ++k) t[6 + k] = ll[k];
  for (int a = 0; a < 3; ++a)
    for (int k = 0; k < 3; ++k) t[12 + a * 3 + k] = pp[a] * cc[a][k];
  const int ij[6][2] = {{0, 0}, {0, 1}, {0, 2}, {1, 1}, {1, 2}, {2, 2}};
  for (int k = 0; k < 6; ++k) {
    int a = ij[k][0], bb = ij[k][1];
    float v = pp[0] * cc[0][a] * cc[0][bb] + pp[1] * cc[1][a] * cc[1][bb] + pp[2] * cc[2][a] * cc[2][bb];
    t[21 + k] = (a == bb) ? v + pp[3 + a] : v;
  }
  for (int q = 0; q < ROW_TERMS; ++q) out[q * os] = t[q];
}

// spring_geometry + spring_force + spring_accumulate's terms of one slot at
// the poses P / Q (read through L2), to out[q * os] for the ROW_TERMS terms
// q.
__device__ __forceinline__ void spring_slot_terms(const JointRows& jr, int sl, int S, int i, int n,
                                                  const float* P, const float* Q, float* out, int os) {
  int other = jr.s_other[sl];
  bool valid = other >= 0;
  int idx = valid ? other : 0;
  bool is_a = jr.s_side[sl] > 0;
  bool is_world = jr.s_world[sl] > 0;
  V3 own_p = ld3cg(P, i, n), oth_p = ld3cg(P, idx, n);
  Q4 own_q = ld4cg(Q, i, n), oth_q = ld4cg(Q, idx, n);
  V3 anchor_a = v3(jr.s_anchor_a[sl], jr.s_anchor_a[S + sl], jr.s_anchor_a[2 * S + sl]);
  V3 anchor_b = v3(jr.s_anchor_b[sl], jr.s_anchor_b[S + sl], jr.s_anchor_b[2 * S + sl]);
  V3 pa_body = is_a ? own_p : oth_p;
  Q4 qa_body = is_a ? own_q : oth_q;
  Q4 qa = is_world ? Q4{F(0.0), F(0.0), F(0.0), F(1.0)} : qa_body;
  V3 rw_a = is_world ? v3(F(0.0), F(0.0), F(0.0)) : qrotate(qa, anchor_a);
  V3 p_a = is_world ? anchor_a : vadd(pa_body, rw_a);
  V3 pb_body = is_a ? oth_p : own_p;
  Q4 qb = is_a ? oth_q : own_q;
  V3 rw_b = qrotate(qb, anchor_b);
  V3 p_b = vadd(pb_body, rw_b);
  V3 delta = vsub(p_a, p_b);
  float cur_len = sqrtf(vdot(delta, delta));
  bool degenerate = cur_len < F(1.0e-6);
  float inv = F(1.0) / (degenerate ? F(1.0) : cur_len);
  V3 nv = degenerate ? v3(F(0.0), F(0.0), F(0.0)) : vscale(delta, inv);
  float C = valid ? cur_len - jr.s_rrest[sl] : F(0.0);
  V3 rw = is_a ? rw_a : rw_b;
  float pen = jr.s_pen[sl];
  float f = valid ? pen * C : F(0.0);

  float sign = is_a ? F(1.0) : F(-1.0);
  float okf = valid ? F(1.0) : F(0.0);
  V3 cv = vcross(rw, nv);
  float fs = f * okf;
  float pp = pen * okf;
  float n3[3] = {nv.x, nv.y, nv.z}, c3[3] = {cv.x, cv.y, cv.z};
  const int ij[6][2] = {{0, 0}, {0, 1}, {0, 2}, {1, 1}, {1, 2}, {2, 2}};
  for (int k = 0; k < 3; ++k) {
    out[k * os] = sign * n3[k] * fs;
    out[(3 + k) * os] = sign * c3[k] * fs;
  }
  for (int k = 0; k < 6; ++k) {
    out[(6 + k) * os] = pp * n3[ij[k][0]] * n3[ij[k][1]];
    out[(21 + k) * os] = pp * c3[ij[k][0]] * c3[ij[k][1]];
  }
  for (int a = 0; a < 3; ++a)
    for (int k = 0; k < 3; ++k) out[(12 + a * 3 + k) * os] = pp * n3[a] * c3[k];
}

// Phase 2 decay of joint and spring slot (t, i) (joint_decay, spring_decay).
__device__ __forceinline__ void row_decay_slot(const JointRows& jr, const KParams& p, int t, int i, int n) {
  if (t < jr.dj) {
    const int S = jr.dj * n, sl = t * n + i;
    bool valid = jr.j_other[sl] >= 0;
    for (int r = 0; r < 6; ++r) {
      float stiff = joint_stiff(jr, sl, r);
      bool soft = (stiff > F(0.0)) && isfinite(stiff);
      float lam = jr.j_lam_in[r * S + sl];
      if (p.post_stabilize == F(0.0)) {
        float dec = lam * p.decay;
        lam = p.joint_ema_rate > F(0.0) ? (soft ? dec : lam) : dec;
      }
      float pen = clipf(jr.j_pen_in[r * S + sl] * p.gamma, p.penalty_min, p.joint_penalty_cap);
      pen = soft ? fminf(pen, stiff) : pen;
      jr.j_lam[r * S + sl] = valid ? lam : F(0.0);
      jr.j_pen[r * S + sl] = pen;
    }
  }
  if (t < jr.ds) {
    const int sl = t * n + i;
    float pen = clipf(jr.s_pen_in[sl] * p.gamma, p.penalty_min, p.penalty_max);
    jr.s_pen[sl] = fminf(pen, jr.s_rstiff[sl]);
  }
}

// Colour sub-pass ci of the block's tile (_kernel_b_math 472-540), from the
// poses (src_p, src_q) into (dst_p, dst_q).  Thread (lane, body) evaluates
// the body's joint and spring slots lane, lane + lanes, ... at the source
// poses and leaves each slot's ROW_TERMS terms in ``rt`` (ROW_TERMS x (DJ +
// DS) x tile floats, body fastest); after a block barrier thread ``body``
// folds them over the slots of each family left to right from slot 0 (the
// order cm.dsum sums in), adds them to the inertia and contact terms (the
// folded F / T in ``fold``, the Hessian in w.mat), solves, and writes the
// new pose of a body of colour ci (every body when there is one colour);
// other bodies are copied.
__device__ __forceinline__ void subpass_tile(const Dims& dm, const Bodies& b, const Work& w, const JointRows& jr,
                                             const KParams& p, const TileIdx& ti, int ci, const float* fold,
                                             float* rt, const float* src_p, const float* src_q, float* dst_p,
                                             float* dst_q) {
  const int n = dm.n, tile = ti.tile, i = ti.base + ti.bl, rows = jr.dj + jr.ds;
  const int os = rows * tile;   // stride between a slot's terms
  RACE_DELAY();
  for (int t = ti.lane; t < rows; t += ti.lanes) {
    float* out = rt + t * tile + ti.bl;
    if (t < jr.dj) {
      const int sl = t * n + i;
      joint_slot_terms(jr, joint_geometry(jr, sl, jr.dj * n, i, n, src_p, src_q), sl, jr.dj * n, out, os);
    } else {
      spring_slot_terms(jr, (t - jr.dj) * n + i, jr.ds * n, i, n, src_p, src_q, out, os);
    }
  }
  __syncthreads();
  if (threadIdx.x >= tile) return;
  bool dyn = b.inv_mass[i] > F(0.0);
  float dynf = dyn ? F(1.0) : F(0.0);
  V3 pos = ld3cg(src_p, i, n);
  Q4 quat = ld4cg(src_q, i, n);
  float F3[3], T3[3], M[24];
  for (int k = 0; k < 3; ++k) {
    F3[k] = fold[k * tile + threadIdx.x];
    T3[k] = fold[(3 + k) * tile + threadIdx.x];
  }
  for (int q = 0; q < 24; ++q) M[q] = w.mat[q * n + i];
  RowAcc acc[2];
  int n_acc = 0;
  const int fams[2][2] = {{0, jr.dj}, {jr.dj, jr.ds}};   // (first slot, slots) of each family
  for (int f = 0; f < 2; ++f) {
    if (fams[f][1] == 0) continue;
    const float* src = rt + fams[f][0] * tile + threadIdx.x;
    for (int q = 0; q < ROW_TERMS; ++q) {
      float v = src[q * os];
      for (int t = 1; t < fams[f][1]; ++t) v = v + src[q * os + t * tile];
      acc[n_acc].v[q] = v;
    }
    ++n_acc;
  }
  float dl[3], da[3];
  body_solve(b, w, p, i, n, pos, quat, F3, T3, M, acc, n_acc, dl, da);
  float applyf = dynf;
  bool applyb = dyn;
  if (jr.n_colors > 1) {
    bool mine = jr.color[i] == ci;
    applyf = dynf * (mine ? F(1.0) : F(0.0));
    applyb = dyn && mine;
  }
  V3 new_pos;
  Q4 nq;
  pose_update(pos, quat, dl, da, applyf, applyb, p, &new_pos, &nq);
  RACE_DELAY();
  st3(dst_p, i, n, new_pos);
  st4(dst_q, i, n, nq);
}

// Joint dual of slot sl at the post-primal poses (joint_dual); hard rows
// only, updated in place.
__device__ __forceinline__ void joint_dual_slot(const JointRows& jr, const KParams& p, int sl, int i, int n,
                                                const float* P, const float* Q) {
  const int S = jr.dj * n;
  RACE_DELAY();
  JointGeom g = joint_geometry(jr, sl, S, i, n, P, Q);
  float worldf = g.is_world ? F(1.0) : F(0.0);
  for (int r = 0; r < 6; ++r) {
    bool hard = !isfinite(joint_stiff(jr, sl, r)) && g.valid;
    float lam = jr.j_lam[r * S + sl], pen = jr.j_pen[r * S + sl];
    float lam_r = hard ? lam + p.joint_dual_rate * pen * g.C[r] : lam;
    float lin_w, ang_w;
    if (r < 3) {
      // rw x e_r in closed form, for the A and the B lever arm
      V3 ra = g.rw_a, rb = g.rw_b;
      V3 ca = r == 0 ? v3(F(0.0), ra.z, -ra.y) : (r == 1 ? v3(-ra.z, F(0.0), ra.x) : v3(ra.y, -ra.x, F(0.0)));
      V3 cb = r == 0 ? v3(F(0.0), rb.z, -rb.y) : (r == 1 ? v3(-rb.z, F(0.0), rb.x) : v3(rb.y, -rb.x, F(0.0)));
      lin_w = F(2.0) - worldf;
      ang_w = vdot(ca, ca) * (F(1.0) - worldf) + vdot(cb, cb);
    } else {
      lin_w = F(0.0);
      ang_w = F(2.0) - worldf;
    }
    float total = lin_w + ang_w;
    float gain = total < F(1.0e-8) ? p.beta : (p.beta * lin_w + p.beta_ang * ang_w) / fmaxf(total, F(1.0e-8));
    float pen_r = hard ? fminf(pen + gain * fabsf(g.C[r]), p.joint_penalty_cap) : pen;
    jr.j_lam[r * S + sl] = lam_r;
    jr.j_pen[r * S + sl] = pen_r;
  }
}

// Floats a body takes in front of the fold in the resident joint loop's
// shared memory: the contact partials, or a sub-pass's row terms where the
// rows outnumber them (a narrow cache).  The same as solver_cuda._tile_shape.
__host__ __device__ __forceinline__ int joint_smem_floats(int dc, int rows) {
  return N_PART * dc > ROW_TERMS * rows ? N_PART * dc : ROW_TERMS * rows;
}

// The barrier between colour sub-passes of the resident joint loop: the
// whole grid (a cooperative launch) or the world's one cluster.
template <bool CLUSTER>
__device__ __forceinline__ void world_sync() {
  if constexpr (CLUSTER) cg::this_cluster().sync();
  else cg::this_grid().sync();
}

// Sweeps of a world with rows, all of ``ip`` in one launch: thread blocks
// of the plan's tiles (32 bodies, or 16 where DC is above 16, so that a
// block keeps 128 registers a thread), resident together (a cooperative
// launch, or one cluster where the world fits one; the launcher checks).
// With ``first`` it opens with the rows' decay and the geometry at the
// predicted poses.  A sweep: the contact partials and their ordered fold at
// the sweep-start poses (primal_tile), then per colour the sub-pass from
// buffer X into buffer Y (subpass_tile: row terms by (slot, body) threads,
// the solve by one thread per body) and the world's barrier, X and Y
// swapping; then the contact dual and (with do_dual) the joint dual at the
// final poses.  A cache slot's and a joint slot's duals, penalties and
// latches are written and read by the one thread that owns the slot, so
// only the poses cross blocks (through L2, ld.global.cg).  No barrier follows the
// dual pass: the next sub-pass writes the buffer that the last barrier
// finished reading, while the dual pass reads the other one.  w.pos / quat:
// buffer X at the launch; ``alt_p`` / ``alt_q``: buffer Y.
template <int MAXT, bool CLUSTER>
__global__ void __launch_bounds__(MAXT) k_joint_sweeps(Dims dm, Cache c, Bodies b, Work w, JointRows jr,
                                                       KParams p, int tile, IterPlan ip, int first, float* alt_p,
                                                       float* alt_q) {
  extern __shared__ float sh[];
  TileIdx ti = tile_index(tile);
  const int n = dm.n, dc = dm.dc, i = ti.base + ti.bl;
  if (first) {
    const int dr = jr.dj > jr.ds ? jr.dj : jr.ds;
    for (int t = ti.lane; t < dr; t += ti.lanes) row_decay_slot(jr, p, t, i, n);
    for (int t = ti.lane; t < dc; t += ti.lanes) geom_slot(dm, c, w, i, t);
  }
  float *xp = w.pos, *xq = w.quat, *yp = alt_p, *yq = alt_q;
  float* fold = sh + joint_smem_floats(dc, jr.dj + jr.ds) * tile;
  for (int it = 0; it < ip.n; ++it) {
    // Rows decayed, slots' geometry and duals written (by their own thread)
    // before primal_tile's first block barrier.
    primal_tile(dm, c, b, w, p, ip.rebuild[it], ip.alpha[it], ti, sh, fold, nullptr);
    for (int ci = 0; ci < jr.n_colors; ++ci) {
      // The row terms reuse the partials' shared memory, free after the
      // fold; the world's barrier below also ends their reads.
      subpass_tile(dm, b, w, jr, p, ti, ci, fold, sh, xp, xq, yp, yq);
      world_sync<CLUSTER>();
      float *tp = xp, *tq = xq;
      xp = yp;
      xq = yq;
      yp = tp;
      yq = tq;
      w.pos = xp;
      w.quat = xq;
      w.snap_pos = xp;
      w.snap_quat = xq;
    }
    for (int t = ti.lane; t < dc; t += ti.lanes)
      dual_slot(dm, c, w, p, slot_ctx(dm, c, b, p, i, t), ip.do_dual[it], ip.ramp[it], ip.alpha[it], i, 0);
    if (jr.dj > 0 && ip.do_dual[it])
      for (int t = ti.lane; t < jr.dj; t += ti.lanes) joint_dual_slot(jr, p, t * n + i, i, n, xp, xq);
  }
}

// The slow joint dual tracker on the final poses (joint_dual_ema), one
// thread per joint slot, after k_final_body.
__global__ void __launch_bounds__(BLOCK) k_joint_ema(Dims dm, JointRows jr, Work w, KParams p) {
  int sl = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = dm.n, S = jr.dj * n;
  if (sl >= S) return;
  JointGeom g = joint_geometry(jr, sl, S, sl % n, n, w.pos, w.quat);
  for (int r = 0; r < 6; ++r) {
    bool hard = !isfinite(joint_stiff(jr, sl, r)) && g.valid;
    float lam = jr.j_lam[r * S + sl];
    jr.j_lam[r * S + sl] = hard ? lam + p.joint_ema_rate * jr.j_pen[r * S + sl] * g.C[r] : lam;
  }
}


// ---------------------------------------------------------------------------
// Phase 5: sanitize + velocities, one thread per body.
// ---------------------------------------------------------------------------

// With w.stick_out (K1) it also stores the body's final latches (``stick``,
// 0 / 1 floats) as the new cache's bools.
__global__ void __launch_bounds__(BLOCK) k_final_body(Dims dm, Bodies b, Work w, KParams p,
                                                      const float* stick) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= dm.n) return;
  const int n = dm.n;
  if (w.stick_out != nullptr)
    for (int q = 0; q < 4 * dm.dc; ++q) w.stick_out[q * n + i] = stick[q * n + i] > F(0.5) ? 1 : 0;
  bool dyn = b.inv_mass[i] > F(0.0);
  int san = 0;
  V3 pos0 = ld3(b.pos, i, n);
  Q4 quat0 = ld4(b.quat, i, n);
  V3 pos_f = san3(ld3(w.pos, i, n), pos0, &san);
  Q4 qf = ld4(w.quat, i, n);
  bool qfin = isfinite(qf.x) && isfinite(qf.y) && isfinite(qf.z) && isfinite(qf.w);
  san += qfin ? 0 : 1;
  Q4 quat_f = qfin ? qf : quat0;
  V3 lv_in = ld3(b.lv, i, n), av_in = ld3(b.av, i, n);
  V3 nlv = v3((pos_f.x - pos0.x) / p.dt * p.linear_damping, (pos_f.y - pos0.y) / p.dt * p.linear_damping,
              (pos_f.z - pos0.z) / p.dt * p.linear_damping);
  nlv = dyn ? nlv : lv_in;
  Q4 dqv = qmul(quat_f, Q4{-quat0.x, -quat0.y, -quat0.z, quat0.w});
  float vsgn = dqv.w < F(0.0) ? F(-2.0) : F(2.0);
  V3 nav = v3(dqv.x * vsgn / p.dt * p.angular_damping, dqv.y * vsgn / p.dt * p.angular_damping,
              dqv.z * vsgn / p.dt * p.angular_damping);
  nav = dyn ? nav : av_in;
  V3 zero = v3(0.f, 0.f, 0.f);
  nlv = san3(nlv, zero, &san);
  nav = san3(nav, zero, &san);
  st3(w.pos, i, n, pos_f);
  st4(w.quat, i, n, quat_f);
  st3(w.lv_out, i, n, nlv);
  st3(w.av_out, i, n, nav);
  if (san) atomicAdd(&w.counters[2], san);
}

// ---------------------------------------------------------------------------
// Phase 6: diagnostics + control lanes, one block.
// ---------------------------------------------------------------------------

// Row 0 of w.diag holds the kernel's lanes: 0-7 the diagnostics, 8
// sanitized, 9 kept directed slots, 10-14 the control lanes, 15 dropped
// manifolds.  With w.cand (K1; null in K4's launch), row 1 holds the same
// numbers in the state layout (state.Diagnostics; the reference's
// solver_tpu.py:1142-1152): 0-8 as row 0, 9 the pair overflow cand - kept
// (an int32 difference, as the reference takes it), 10 the dropped
// manifolds, 11-15 the control lanes.  Every other entry is 0.
// ``with_ctrl`` 0 (K4): lanes 0-8 only, the rest 0, no control lanes.
__global__ void __launch_bounds__(CTRL_THREADS) k_final_reduce(Dims dm, Cache c, Bodies b, Work w, KParams p,
                                                               CtrlIn ctrl, int with_ctrl) {
  __shared__ float sh[8 * CTRL_THREADS];
  const int n = dm.n, S = dm.dc * dm.n;
  float max_pen = F(0.0), max_drift = F(0.0), max_lam_n = F(0.0), max_lin = F(0.0), max_ang = F(0.0);
  float n_contacts = F(0.0), n_manifolds = F(0.0), n_dyn = F(0.0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float dynf = b.inv_mass[i] > F(0.0) ? F(1.0) : F(0.0);
    n_dyn += dynf;
    V3 lv = ld3(w.lv_out, i, n), av = ld3(w.av_out, i, n);
    max_lin = max_nan(max_lin, sqrtf(vdot(lv, lv)) * dynf);
    max_ang = max_nan(max_ang, sqrtf(vdot(av, av)) * dynf);
    for (int t = 0; t < dm.dc; ++t) {
      int sl = t * n + i;
      int other = c.other[sl];
      bool valid = other >= 0;
      int idx = valid ? other : 0;
      bool other_dyn = (b.inv_mass[idx] > F(0.0) ? F(1.0) : F(0.0)) > F(0.5);
      bool once = valid && ((i < idx) || !other_dyn);
      int count = c.count[sl];
      if (once) {
        n_contacts += (float)count;
        n_manifolds += count > 0 ? F(1.0) : F(0.0);
      }
      for (int s = 0; s < 4; ++s) {
        bool ok = (s < count) && valid;
        float sep = w.geom[(24 + s) * S + sl];
        max_pen = max_nan(max_pen, ok ? -sep : F(0.0));
        max_drift = max_nan(max_drift, ok ? p.penetration_slop - sep : F(0.0));
        max_lam_n = max_nan(max_lam_n, ok ? fabsf(c.lam[(s * 3) * S + sl]) : F(0.0));
      }
    }
  }
  float v[8] = {max_pen, max_drift, max_lin, max_ang, max_lam_n, n_contacts, n_manifolds, n_dyn};
  const int ops[8] = {0, 0, 0, 0, 0, 2, 2, 2};
  block_reduce(v, ops, 8, sh);
  float ctrl_out[5] = {F(0.0), F(0.0), F(0.0), F(0.0), F(0.0)};
  __shared__ float ctrl_sh[5];
  if (with_ctrl) {
    control_lanes_block(ctrl, p, ctrl_sh, sh);
    __syncthreads();
    for (int k = 0; k < 5; ++k) ctrl_out[k] = ctrl_sh[k];
  }
  for (int j = threadIdx.x; j < 8 * 128; j += blockDim.x) {
    float val = F(0.0);
    if (j < 16) {  // row 0, the kernel's lanes
      if (j < 8) val = v[j];
      else if (j == 8) val = (float)w.counters[2];
      else if (!with_ctrl) val = F(0.0);
      else if (j == 9) val = (float)w.counters[0];
      else if (j < 15) val = ctrl_out[j - 10];
      else val = (float)w.counters[1];
    } else if (j >= 128 && j < 144 && w.cand != nullptr) {  // row 1, the state layout
      const int k = j - 128;
      if (k < 8) val = v[k];
      else if (k == 8) val = (float)w.counters[2];
      else if (k == 9) val = (float)(*w.cand - w.counters[0]);
      else if (k == 10) val = (float)w.counters[1];
      else val = ctrl_out[k - 11];
    }
    w.diag[j] = val;
  }
}

// ---------------------------------------------------------------------------
// Host entry point
// ---------------------------------------------------------------------------

// Dynamic shared memory above 48 KB and cluster sizes above 8 are opt-in,
// once per kernel.
template <typename K>
static cudaError_t opt_in(K kernel, bool clusters) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (err == cudaSuccess && clusters)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

static bool plan_ok(const SweepPlan& pl, const Dims& dm) {
  return pl.tile > 0 && pl.threads > 0 && pl.threads <= 1024 && pl.threads % pl.tile == 0 &&
         dm.n % pl.tile == 0 && pl.smem >= (int)sizeof(float) * (N_PART * dm.dc + 6) * pl.tile &&
         pl.cluster >= 0 && pl.cluster <= 16 && (pl.grid == 0 || pl.grid == 1) && !(pl.grid && pl.cluster);
}

template <int MAXT>
static cudaError_t launch_primal_t(const SweepPlan& pl, Dims dm, Cache c, Bodies b, Work w, KParams p, int rebuild,
                                   float alpha_cur, cudaStream_t st) {
  static bool ready = false;
  if (!ready) {
    cudaError_t err = opt_in(k_primal<MAXT>, false);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  k_primal<MAXT><<<dm.n / pl.tile, pl.threads, pl.smem, st>>>(dm, c, b, w, p, pl.tile, rebuild, alpha_cur);
  return cudaGetLastError();
}

cudaError_t launch_primal(const SweepPlan& pl, Dims dm, Cache c, Bodies b, Work w, KParams p, int rebuild,
                          float alpha_cur, cudaStream_t st) {
  if (!plan_ok(pl, dm)) return cudaErrorInvalidValue;
  if (pl.threads <= 512) return launch_primal_t<512>(pl, dm, c, b, w, p, rebuild, alpha_cur, st);
  return launch_primal_t<1024>(pl, dm, c, b, w, p, rebuild, alpha_cur, st);
}

template <int MAXT>
static cudaError_t launch_sweeps_t(const SweepPlan& pl, Dims dm, Cache c, Bodies b, Work w, KParams p,
                                   const IterPlan& ip, int with_geom, Carry carry, cudaStream_t st) {
  static bool ready = false;
  static int ok_threads = 0, ok_smem = 0, ok_cluster = 0;
  if (!ready) {
    cudaError_t err = opt_in(k_sweeps<MAXT>, true);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(dm.n / pl.tile, 1, 1);
  cfg.blockDim = dim3(pl.threads, 1, 1);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (pl.threads != ok_threads || pl.smem != ok_smem || pl.cluster != ok_cluster) {
    // Schedulability of this shape, checked once: a cluster that fits no GPC
    // would never start.
    int max_clusters = 0;
    cudaError_t err = cudaOccupancyMaxActiveClusters(&max_clusters, k_sweeps<MAXT>, &cfg);
    if (err != cudaSuccess) return err;
    if (max_clusters < 1) return cudaErrorLaunchOutOfResources;
    ok_threads = pl.threads;
    ok_smem = pl.smem;
    ok_cluster = pl.cluster;
  }
  return cudaLaunchKernelEx(&cfg, k_sweeps<MAXT>, dm, c, b, w, p, pl.tile, ip, with_geom, carry);
}

cudaError_t launch_sweeps(const SweepPlan& pl, Dims dm, Cache c, Bodies b, Work w, KParams p, const IterPlan& ip,
                          int with_geom, Carry carry, cudaStream_t st) {
  if (!plan_ok(pl, dm) || pl.cluster < 1 || pl.tile * pl.cluster != w.blk || dm.n % w.blk != 0)
    return cudaErrorInvalidValue;
  if (pl.threads <= 512) return launch_sweeps_t<512>(pl, dm, c, b, w, p, ip, with_geom, carry, st);
  if (pl.threads <= 768) return launch_sweeps_t<768>(pl, dm, c, b, w, p, ip, with_geom, carry, st);
  return launch_sweeps_t<1024>(pl, dm, c, b, w, p, ip, with_geom, carry, st);
}

template <int MAXT, bool CLUSTER>
static cudaError_t launch_joint_sweeps_t(const SweepPlan& pl, Dims dm, Cache c, Bodies b, Work w, JointRows jr,
                                         KParams p, const IterPlan& ip, int first, float* alt_p, float* alt_q,
                                         cudaStream_t st) {
  static bool ready = false;
  static int ok_n = 0, ok_threads = 0, ok_smem = 0;
  if (!ready) {
    cudaError_t err = opt_in(k_joint_sweeps<MAXT, CLUSTER>, CLUSTER);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int blocks = dm.n / pl.tile;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(pl.threads, 1, 1);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  if (CLUSTER) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = pl.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
  } else {
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
  }
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (dm.n != ok_n || pl.threads != ok_threads || pl.smem != ok_smem) {
    // Every block of the launch must be resident at once, checked once per
    // shape: a grid barrier over blocks that cannot all run would hang.
    if (CLUSTER) {
      int max_clusters = 0;
      cudaError_t err = cudaOccupancyMaxActiveClusters(&max_clusters, k_joint_sweeps<MAXT, CLUSTER>, &cfg);
      if (err != cudaSuccess) return err;
      if (max_clusters < 1) return cudaErrorLaunchOutOfResources;
    } else {
      int dev = 0, sms = 0, per_sm = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_joint_sweeps<MAXT, CLUSTER>, pl.threads,
                                                            pl.smem);
      if (err != cudaSuccess) return err;
      if (per_sm * sms < blocks) return cudaErrorCooperativeLaunchTooLarge;
    }
    ok_n = dm.n;
    ok_threads = pl.threads;
    ok_smem = pl.smem;
  }
  return cudaLaunchKernelEx(&cfg, k_joint_sweeps<MAXT, CLUSTER>, dm, c, b, w, jr, p, pl.tile, ip, first, alt_p,
                            alt_q);
}

// The resident sweeps of a world with rows: a cooperative launch (pl.grid)
// or, where the world is one cluster (tile * cluster = N), a cluster launch.
static cudaError_t launch_joint_sweeps(const SweepPlan& pl, Dims dm, Cache c, Bodies b, Work w, JointRows jr,
                                       KParams p, const IterPlan& ip, int first, float* alt_p, float* alt_q,
                                       cudaStream_t st) {
  if (!plan_ok(pl, dm) || (pl.grid == 0 && pl.cluster * pl.tile != dm.n) ||
      pl.smem < (int)sizeof(float) * (joint_smem_floats(dm.dc, jr.dj + jr.ds) + 6) * pl.tile)
    return cudaErrorInvalidValue;
  if (pl.grid) {
    if (pl.threads <= 512)
      return launch_joint_sweeps_t<512, false>(pl, dm, c, b, w, jr, p, ip, first, alt_p, alt_q, st);
    return launch_joint_sweeps_t<1024, false>(pl, dm, c, b, w, jr, p, ip, first, alt_p, alt_q, st);
  }
  if (pl.threads <= 512)
    return launch_joint_sweeps_t<512, true>(pl, dm, c, b, w, jr, p, ip, first, alt_p, alt_q, st);
  return launch_joint_sweeps_t<1024, true>(pl, dm, c, b, w, jr, p, ip, first, alt_p, alt_q, st);
}

// Sweep it of a step's loop (solve_half's plan): alpha and the three flags.
static void step_iter(const KParams& p, int it, int n_main, int iters_end, int k, float* alpha, int* do_dual,
                      int* rebuild, int* ramp) {
  *rebuild = (it % k) == 0;
  *ramp = ((it % k) == k - 1) || (it == iters_end - 1);
  *alpha = p.post_stabilize != F(0.0) ? (it < n_main ? F(1.0) : F(0.0)) : p.alpha;
  *do_dual = it < n_main;
}

// Sweeps s .. s + MAX_RESIDENT_ITERS - 1 of a step's loop as one resident
// launch's plan.
static IterPlan iter_plan(const KParams& p, int s, int n_main, int iters_end, int k) {
  IterPlan ip = {};
  ip.n = iters_end - s < MAX_RESIDENT_ITERS ? iters_end - s : MAX_RESIDENT_ITERS;
  for (int j = 0; j < ip.n; ++j) {
    int do_dual, rebuild, ramp;
    step_iter(p, s + j, n_main, iters_end, k, &ip.alpha[j], &do_dual, &rebuild, &ramp);
    ip.do_dual[j] = do_dual;
    ip.rebuild[j] = rebuild;
    ip.ramp[j] = ramp;
  }
  return ip;
}

extern "C" {

// Rows of a jointed world from ptrs 54-76 (see avbd_step).
static JointRows rows_from(void** ptrs, int dj, int ds, int n_colors) {
  JointRows jr;
  jr.dj = dj;
  jr.ds = ds;
  jr.n_colors = n_colors;
  void** j = ptrs + 56;
  jr.j_other = (const int*)j[0];
  jr.j_world = (const int*)j[1];
  jr.j_side = (const int*)j[2];
  jr.j_anchor_a = (const float*)j[3];
  jr.j_anchor_b = (const float*)j[4];
  jr.j_rest = (const float*)j[5];
  jr.j_stiff_lin = (const float*)j[6];
  jr.j_stiff_ang = (const float*)j[7];
  jr.j_rmotor = (const float*)j[8];
  jr.j_lam_in = (const float*)j[9];
  jr.j_pen_in = (const float*)j[10];
  jr.color = (const int*)j[11];
  void** s = ptrs + 68;
  jr.s_other = (const int*)s[0];
  jr.s_world = (const int*)s[1];
  jr.s_side = (const int*)s[2];
  jr.s_anchor_a = (const float*)s[3];
  jr.s_anchor_b = (const float*)s[4];
  jr.s_rrest = (const float*)s[5];
  jr.s_rstiff = (const float*)s[6];
  jr.s_pen_in = (const float*)s[7];
  jr.j_lam = (float*)ptrs[76];
  jr.j_pen = (float*)ptrs[77];
  jr.s_pen = (float*)ptrs[78];
  return jr;
}

// The solve of a step after its collide, shared by avbd_step (K1) and
// avbd_solve_loop (K4): prediction, slot geometry, the sweeps and the final
// velocities.  With joint or spring rows (jr.dj or jr.ds > 0): the rows'
// decay, the geometry and all sweeps in resident launches of at most
// MAX_RESIDENT_ITERS sweeps (k_joint_sweeps; one launch for any scene of the
// repository), ping-ponging between w's pose buffers and pos_b / quat_b, and
// k_joint_ema after k_final_body.  Contact-only with pl.cluster > 0: the
// geometry and all sweeps in cluster-resident launches (k_sweeps).
// Contact-only otherwise: k_geom, then k_primal + k_dual per sweep.  On
// return w's poses are its output buffers again.
static cudaError_t solve_phases(const SweepPlan& pl, Dims dm, Cache c, Bodies b, Work* wp, KParams p,
                                const JointRows& jr, float* pos_b, float* quat_b, int n_main, int iters_end,
                                int k_rebuild, cudaStream_t st) {
  Work& w = *wp;
  const int n = dm.n, dj = jr.dj;
  const int nb_body = blocks_for(n), nb_slot = blocks_for(dm.dc * n);
  const bool rows = jr.dj > 0 || jr.ds > 0;
  const int k = k_rebuild < 1 ? 1 : k_rebuild;
  cudaError_t err;
  // Worlds with rows take a resident route, contact-only worlds never the grid one.
  if (rows ? (pl.grid == 0 && pl.cluster == 0) : pl.grid != 0) return cudaErrorInvalidValue;
  k_predict<<<nb_body, BLOCK, 0, st>>>(dm, b, w, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  float* const out_pos = w.pos;
  float* const out_quat = w.quat;
  if (rows) {
    float* buf_p[2] = {out_pos, pos_b};
    float* buf_q[2] = {out_quat, quat_b};
    int cur = 0;
    for (int s = 0; s < iters_end || s == 0; s += MAX_RESIDENT_ITERS) {
      IterPlan ip = iter_plan(p, s, n_main, iters_end, k);
      w.pos = buf_p[cur];
      w.quat = buf_q[cur];
      w.snap_pos = w.pos;
      w.snap_quat = w.quat;
      err = launch_joint_sweeps(pl, dm, c, b, w, jr, p, ip, s == 0, buf_p[cur ^ 1], buf_q[cur ^ 1], st);
      if (err != cudaSuccess) return err;
      cur ^= (ip.n * jr.n_colors) & 1;
    }
    w.pos = buf_p[cur];
    w.quat = buf_q[cur];
  } else if (pl.cluster > 0) {
    const Carry none = {};
    for (int s = 0; s < iters_end || s == 0; s += MAX_RESIDENT_ITERS)
      if ((err = launch_sweeps(pl, dm, c, b, w, p, iter_plan(p, s, n_main, iters_end, k), s == 0, none, st)) !=
          cudaSuccess)
        return err;
  } else {
    k_geom<<<nb_slot, BLOCK, 0, st>>>(dm, c, w);
    for (int it = 0; it < iters_end; ++it) {
      float alpha_cur;
      int do_dual, rebuild, ramp;
      step_iter(p, it, n_main, iters_end, k, &alpha_cur, &do_dual, &rebuild, &ramp);
      if ((err = launch_primal(pl, dm, c, b, w, p, rebuild, alpha_cur, st)) != cudaSuccess) return err;
      k_dual<<<nb_slot, BLOCK, 0, st>>>(dm, c, b, w, p, do_dual, ramp, alpha_cur);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (w.pos != out_pos) {
    err = cudaMemcpyAsync(out_pos, w.pos, 3 * (size_t)n * sizeof(float), cudaMemcpyDeviceToDevice, st);
    if (err == cudaSuccess)
      err = cudaMemcpyAsync(out_quat, w.quat, 4 * (size_t)n * sizeof(float), cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return err;
    w.pos = out_pos;
    w.quat = out_quat;
    w.snap_pos = out_pos;
    w.snap_quat = out_quat;
  }
  k_final_body<<<nb_body, BLOCK, 0, st>>>(dm, b, w, p, c.stick);
  if (dj > 0 && p.joint_ema_rate > F(0.0)) k_joint_ema<<<blocks_for(dj * n), BLOCK, 0, st>>>(dm, jr, w, p);
  return cudaGetLastError();
}

// ptrs (in order):
//   0-11  old cache: other, count, feature, r_a, r_b, normal, stick (bool),
//         c0_n, c0_t1, c0_t2, lam, penalty
//   12-14 nb, key, thr
//   15-28 pos, quat, size, radius, linvel, angvel, prev_linvel, mass,
//         inv_mass, friction, inertia, inv_inertia, anchor, anchor_quat
//   29-40 new cache (same order as 0-11; stick bool)
//   41-46 pos, quat, linvel, angvel, prev_linvel, prev_angvel (outputs)
//   47    diag (8, 128)
//   48-52 scratch: ip (3N), iq (4N), geom (36 DC N), mat (24 N) floats;
//         nbc (DC N) ints
//   53    counters (3 ints)
//   54    cand (1 int: diag row 1 in the state layout)
//   55    scratch: the new cache's latches as 0 / 1 floats (4 DC N)
// and only when dj or ds > 0 (the joint/spring branch):
//   56-67 joints: other, world, side, anchor_a, anchor_b, rest, stiff_lin,
//         stiff_ang, rmotor, lam, penalty, color
//   68-75 springs: other, world, side, anchor_a, anchor_b, rrest, rstiff,
//         penalty
//   76-78 outputs j_lam, j_pen (6 DJ N), s_pen (DS N)
//   79-80 scratch: second pose buffer pos (3N), quat (4N)
// ``plan``: the shape's sweep plan, PLAN_INTS ints in SweepPlan order.
// Returns the first non-zero CUDA error code, or 0.
int avbd_step(void** ptrs, const float* params, int n, int d, int dc, int dj, int ds, int n_colors,
              int n_main, int iters_end, int k_rebuild, const int* plan, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const SweepPlan pl = plan_from(plan);
  if (dc > d || n % 128 != 0 || dj < 0 || ds < 0 || n_colors < 1) return (int)cudaErrorInvalidValue;
  KParams p = *(const KParams*)params;
  Dims dm{n, d, dc};
  Cache old, c;
  cache_from(ptrs, &old);
  cache_from(ptrs + 29, &c);
  old.stick_b = (const unsigned char*)ptrs[6];
  old.stick = nullptr;
  c.stick = (float*)ptrs[55];
  const int* nb = (const int*)ptrs[12];
  const int* key = (const int*)ptrs[13];
  const int* thr = (const int*)ptrs[14];
  Bodies b;
  b.pos = (const float*)ptrs[15];
  b.quat = (const float*)ptrs[16];
  b.size = (const float*)ptrs[17];
  b.radius = (const float*)ptrs[18];
  b.lv = (const float*)ptrs[19];
  b.av = (const float*)ptrs[20];
  b.plv = (const float*)ptrs[21];
  b.mass = (const float*)ptrs[22];
  b.inv_mass = (const float*)ptrs[23];
  b.friction = (const float*)ptrs[24];
  b.inertia = (const float*)ptrs[25];
  b.inv_inertia = (const float*)ptrs[26];
  const float* anchor = (const float*)ptrs[27];
  const float* anchor_q = (const float*)ptrs[28];
  Work w;
  w.pos = (float*)ptrs[41];
  w.quat = (float*)ptrs[42];
  w.lv_out = (float*)ptrs[43];
  w.av_out = (float*)ptrs[44];
  w.plv_out = (float*)ptrs[45];
  w.pav_out = (float*)ptrs[46];
  w.diag = (float*)ptrs[47];
  w.ip = (float*)ptrs[48];
  w.iq = (float*)ptrs[49];
  w.geom = (float*)ptrs[50];
  w.mat = (float*)ptrs[51];
  w.nbc = (int*)ptrs[52];
  w.counters = (int*)ptrs[53];
  w.stick_out = (unsigned char*)ptrs[35];
  w.cand = (const int*)ptrs[54];
  w.keptmask = nullptr;
  w.once = nullptr;
  w.snap_pos = w.pos;
  w.snap_quat = w.quat;
  w.blk = n;

  cudaError_t err = cudaMemsetAsync(w.counters, 0, 3 * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const bool rows = dj > 0 || ds > 0;
  JointRows jr = {};
  if (rows) jr = rows_from(ptrs, dj, ds, dj > 0 ? n_colors : 1);
  if ((err = launch_collide(dm, nb, key, thr, old, c, b, w, p, st)) != cudaSuccess) return (int)err;
  err = solve_phases(pl, dm, c, b, &w, p, jr, rows ? (float*)ptrs[79] : nullptr,
                     rows ? (float*)ptrs[80] : nullptr, n_main, iters_end, k_rebuild, st);
  if (err != cudaSuccess) return (int)err;
  CtrlIn ctrl;
  ctrl.nb = nb;
  ctrl.pos = w.pos;
  ctrl.quat = w.quat;
  ctrl.size = b.size;
  ctrl.radius = b.radius;
  ctrl.lv = w.lv_out;
  ctrl.av = w.av_out;
  ctrl.inv_mass = b.inv_mass;
  ctrl.anchor = anchor;
  ctrl.anchor_q = anchor_q;
  ctrl.n = n;
  ctrl.d = d;
  k_final_reduce<<<1, CTRL_THREADS, 0, st>>>(dm, c, b, w, p, ctrl, 1);
  return (int)cudaGetLastError();
}

// K3, the collide half of K1 (collide_and_init_tpu).  ptrs (in order):
//   0-11  old cache; 12-14 nb, key, thr; 15-18 pos, quat, size, inv_mass
//   19-30 new cache; 31 scratch nbc (DC, N) ints; 32 counters (3 ints:
//   kept directed slots, dropped manifolds, -)
// Returns the first non-zero CUDA error code, or 0.
int avbd_collide(void** ptrs, const float* params, int n, int d, int dc, void* stream) {
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
  w.nbc = (int*)ptrs[31];
  w.counters = (int*)ptrs[32];
  cudaError_t err = cudaMemsetAsync(w.counters, 0, 3 * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_collide(dm, (const int*)ptrs[12], (const int*)ptrs[13], (const int*)ptrs[14], old, c, b, w,
                             p, st);
}

// K4, the solve half of K1 for a contact-only world (solve_loop_tpu):
// prediction, the sweeps, velocities and diagnostics lanes 0-8.  ptrs:
//   0-11  cache (the collide's output; lam, penalty, stick are read only)
//   12-21 pos, quat, linvel, angvel, prev_linvel, mass, inv_mass, friction,
//         inertia, inv_inertia
//   22-27 outputs pos, quat, linvel, angvel, prev_linvel, prev_angvel
//   28-30 outputs lam, penalty (12 DC N), stick (4 DC N, 0/1 floats)
//   31    diag (8, 128)
//   32-35 scratch ip (3N), iq (4N), geom (36 DC N), mat (24 N)
//   36    counters (3 ints)
// ``plan``: the shape's sweep plan, PLAN_INTS ints in SweepPlan order.
// Returns the first non-zero CUDA error code, or 0.
int avbd_solve_loop(void** ptrs, const float* params, int n, int dc, int n_main, int iters_end, int k_rebuild,
                    const int* plan, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const SweepPlan pl = plan_from(plan);
  if (n % 128 != 0) return (int)cudaErrorInvalidValue;
  KParams p = *(const KParams*)params;
  Dims dm{n, dc, dc};
  const size_t f4 = sizeof(float), slots = (size_t)dc * n;
  const int src[3] = {10, 11, 6};
  const size_t sizes[3] = {12 * slots * f4, 12 * slots * f4, 4 * slots * f4};
  for (int q = 0; q < 3; ++q) {
    cudaError_t err = cudaMemcpyAsync(ptrs[28 + q], ptrs[src[q]], sizes[q], cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return (int)err;
  }
  Cache c;
  cache_from(ptrs, &c);
  c.lam = (float*)ptrs[28];
  c.pen = (float*)ptrs[29];
  c.stick = (float*)ptrs[30];
  Bodies b = {};
  b.pos = (const float*)ptrs[12];
  b.quat = (const float*)ptrs[13];
  b.lv = (const float*)ptrs[14];
  b.av = (const float*)ptrs[15];
  b.plv = (const float*)ptrs[16];
  b.mass = (const float*)ptrs[17];
  b.inv_mass = (const float*)ptrs[18];
  b.friction = (const float*)ptrs[19];
  b.inertia = (const float*)ptrs[20];
  b.inv_inertia = (const float*)ptrs[21];
  Work w = {};
  w.pos = (float*)ptrs[22];
  w.quat = (float*)ptrs[23];
  w.lv_out = (float*)ptrs[24];
  w.av_out = (float*)ptrs[25];
  w.plv_out = (float*)ptrs[26];
  w.pav_out = (float*)ptrs[27];
  w.diag = (float*)ptrs[31];
  w.ip = (float*)ptrs[32];
  w.iq = (float*)ptrs[33];
  w.geom = (float*)ptrs[34];
  w.mat = (float*)ptrs[35];
  w.counters = (int*)ptrs[36];
  w.snap_pos = w.pos;
  w.snap_quat = w.quat;
  w.blk = n;
  cudaError_t err = cudaMemsetAsync(w.counters, 0, 3 * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const JointRows jr = {};
  err = solve_phases(pl, dm, c, b, &w, p, jr, nullptr, nullptr, n_main, iters_end, k_rebuild, st);
  if (err != cudaSuccess) return (int)err;
  CtrlIn ctrl = {};
  k_final_reduce<<<1, CTRL_THREADS, 0, st>>>(dm, c, b, w, p, ctrl, 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
