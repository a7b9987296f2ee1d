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
//    poses cross threads, through L2.  Larger worlds, and worlds with joint or spring
//    rows (colour sub-passes ping-pong two pose buffers), take one launch per
//    half-sweep.  Which of the two a shape takes is decided before the
//    launch by solver_cuda.sweep_plan, whose numbers the entry points
//    receive; a cluster launch that cannot be scheduled is an error.
//   k_filter_cull   1 thread / body         symmetric filter + ordered precull
//   k_collide       1 thread / (slot, body) SAT, warmstart match, row init
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
//   k_final_body    1 thread / body         sanitize, velocities
//   k_final_reduce  1 block                 diagnostics lanes + control lanes
// 6 launches per contact step on the cluster route, 6 + 2 per sweep on the
// launch route.  The iteration count and the Hessian cadence are runtime
// arguments, so the calm, fresh and boosted variants share this code.
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
// Narrowphase: collide_pairs_cm for one pair (ops/narrowphase_cm.py).
// ---------------------------------------------------------------------------

struct PairOut {
  V3 normal;      // B -> A
  V3 x_a[4];
  V3 x_b[4];
  int feature[4];
  bool ok[4];
};

__device__ __forceinline__ V3 sel3v(int idx, const V3* items) {
  return idx == 0 ? items[0] : (idx == 1 ? items[1] : items[2]);
}
__device__ __forceinline__ float sel3f(int idx, const float* items) {
  return idx == 0 ? items[0] : (idx == 1 ? items[1] : items[2]);
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

static __device__ void collide_pair(V3 pa, Q4 qa, V3 ha, V3 pb, Q4 qb, V3 hb, float margin, PairOut* out) {
  V3 axa[3], axb[3];
  qaxes(qa, axa);
  qaxes(qb, axb);
  V3 delta = vsub(pb, pa);

  float fsep[6], esep[9];
  bool fval[6], evalid[9];
  V3 fn[6], en[9];
  for (int k = 0; k < 3; ++k) test_axis(axa[k], delta, axa, axb, ha, hb, &fsep[k], &fval[k], &fn[k]);
  for (int k = 0; k < 3; ++k) test_axis(axb[k], delta, axa, axb, ha, hb, &fsep[3 + k], &fval[3 + k], &fn[3 + k]);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      test_axis(vcross(axa[i], axb[j]), delta, axa, axb, ha, hb, &esep[i * 3 + j], &evalid[i * 3 + j], &en[i * 3 + j]);

  bool separated = false;
  for (int k = 0; k < 6; ++k) separated = separated || (fval[k] && (fsep[k] > margin));
  for (int k = 0; k < 9; ++k) separated = separated || (evalid[k] && (esep[k] > margin));

  float best_face_sep = fval[0] ? fsep[0] : NEG_BIG;
  int best_face = 0;
  for (int k = 1; k < 6; ++k) {
    float s = fval[k] ? fsep[k] : NEG_BIG;
    if (s > best_face_sep) { best_face_sep = s; best_face = k; }
  }
  float best_edge_sep = evalid[0] ? esep[0] : NEG_BIG;
  int best_edge = 0;
  for (int k = 1; k < 9; ++k) {
    float s = evalid[k] ? esep[k] : NEG_BIG;
    if (s > best_edge_sep) { best_edge_sep = s; best_edge = k; }
  }
  bool edge_any = false;
  for (int k = 0; k < 9; ++k) edge_any = edge_any || evalid[k];
  bool use_edge = edge_any && (F(0.95) * best_edge_sep > best_face_sep + F(0.01)) && (best_edge_sep > F(-0.05));

  // ---- face manifold ----
  bool ref_is_a = best_face < 3;
  int ref_axis = ref_is_a ? best_face : best_face - 3;
  V3 normal_ab = fn[best_face];
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

  float cand_u[24], cand_v[24], cand_h[24];
  bool cand_ok[24];
  for (int m = 0; m < 4; ++m) {
    cand_u[m] = cu[m];
    cand_v[m] = cv[m];
    cand_ok[m] = (fabsf(cu[m]) <= eu + F(1.0e-5)) && (fabsf(cv[m]) <= ev + F(1.0e-5));
  }
  int c = 4;
  for (int m = 0; m < 4; ++m) {
    int m2 = (m + 1) % 4;
    float du = cu[m2] - cu[m];
    float dv = cv[m2] - cv[m];
    for (int side = 0; side < 4; ++side) {
      bool side_u = side < 2;
      float side_sign = (side % 2 == 0) ? F(1.0) : F(-1.0);
      float bound, dcoord, ccoord, oc, od, oext;
      if (side_u) {
        bound = eu * side_sign; dcoord = du; ccoord = cu[m]; oc = cv[m]; od = dv; oext = ev;
      } else {
        bound = ev * side_sign; dcoord = dv; ccoord = cv[m]; oc = cu[m]; od = du; oext = eu;
      }
      bool denom_ok = fabsf(dcoord) > F(1.0e-6);
      float t = (bound - ccoord) / (denom_ok ? dcoord : F(1.0));
      float hit = oc + t * od;
      bool ok = denom_ok && (t >= F(-1.0e-5)) && (t <= F(1.0 + 1.0e-5)) && (fabsf(hit) <= oext + F(1.0e-5));
      // bound + 0 (the reference adds a zero tensor): turns -0 into +0
      float bz = bound + F(0.0);
      if (side_u) { cand_u[c] = bz; cand_v[c] = hit; }
      else { cand_u[c] = hit; cand_v[c] = bz; }
      cand_ok[c] = ok;
      ++c;
    }
  }
  float area2 = (cu[1] - cu[0]) * (cv[2] - cv[0]) - (cv[1] - cv[0]) * (cu[2] - cu[0])
              + (cu[2] - cu[0]) * (cv[3] - cv[0]) - (cv[2] - cv[0]) * (cu[3] - cu[0]);
  float wind = area2 >= F(0.0) ? F(1.0) : F(-1.0);
  for (int m = 0; m < 4; ++m) {
    float ru = su[m] * eu;
    float rv = sv[m] * ev;
    bool inside = true;
    for (int e = 0; e < 4; ++e) {
      int e2 = (e + 1) % 4;
      float z = (cu[e2] - cu[e]) * (rv - cv[e]) - (cv[e2] - cv[e]) * (ru - cu[e]);
      inside = inside && ((z * wind) >= F(-1.0e-5));
    }
    cand_u[c] = ru;
    cand_v[c] = rv;
    cand_ok[c] = inside;
    ++c;
  }
  for (int k = 0; k < 24; ++k) {
    cand_h[k] = h0 + hu * cand_u[k] + hv * cand_v[k];
    cand_ok[k] = cand_ok[k] && (cand_h[k] <= margin);
  }

  // ---- reduce to <= 4 picks: deepest, farthest, +/- max area ----
  bool valid[24];
  for (int k = 0; k < 24; ++k) valid[k] = cand_ok[k];
  float score[24];
  int ip[4];
  bool found[4];
  float pu[4], pv[4];
  for (int pick = 0; pick < 4; ++pick) {
    for (int k = 0; k < 24; ++k) {
      float u = cand_u[k], v = cand_v[k];
      if (pick == 0) score[k] = -cand_h[k];
      else if (pick == 1) score[k] = (u - pu[0]) * (u - pu[0]) + (v - pv[0]) * (v - pv[0]);
      else {
        float a01 = (pu[1] - pu[0]) * (v - pv[0]) - (pv[1] - pv[0]) * (u - pu[0]);
        score[k] = pick == 2 ? a01 : -a01;
      }
    }
    float best_s = valid[0] ? score[0] : NEG_BIG;
    int best_i = 0;
    for (int k = 1; k < 24; ++k) {
      float s = valid[k] ? score[k] : NEG_BIG;
      if (s > best_s) { best_s = s; best_i = k; }
    }
    ip[pick] = best_i;
    found[pick] = best_s > F(-3.0e38 * 0.5);
    pu[pick] = cand_u[best_i];
    pv[pick] = cand_v[best_i];
    if (pick < 3) {
      for (int k = 0; k < 24; ++k) {
        float du = cand_u[k] - pu[pick], dv = cand_v[k] - pv[pick];
        valid[k] = valid[k] && ((du * du + dv * dv) >= F(1.0e-6));
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
  V3 edge_n = en[best_edge];
  V3 ec_a, eh_a, ec_b, eh_b;
  support_edge(axa, hav, e_i, edge_n, &ec_a, &eh_a);
  support_edge(axb, hbv, e_j, vneg(edge_n), &ec_b, &eh_b);
  V3 p0 = vsub(vadd(pa, ec_a), eh_a);
  V3 p1 = vadd(vadd(pa, ec_a), eh_a);
  V3 q0 = vsub(vadd(pb, ec_b), eh_b);
  V3 q1 = vadd(vadd(pb, ec_b), eh_b);
  V3 d1 = vsub(p1, p0), d2 = vsub(q1, q0), r = vsub(p0, q0);
  float a = vdot(d1, d1), e = vdot(d2, d2), f = vdot(d2, r), cc = vdot(d1, r), b = vdot(d1, d2);
  float denom = a * e - b * b;
  float a_safe = a > F(1.0e-6) ? a : F(1.0);
  float e_safe = e > F(1.0e-6) ? e : F(1.0);
  bool den_ok = fabsf(denom) > F(1.0e-6);
  float s = den_ok ? clipf((b * f - cc * e) / (den_ok ? denom : F(1.0)), F(0.0), F(1.0)) : F(0.0);
  float t = (b * s + f) / e_safe;
  s = t < F(0.0) ? clipf(-cc / a_safe, F(0.0), F(1.0))
                 : (t > F(1.0) ? clipf((b - cc) / a_safe, F(0.0), F(1.0)) : s);
  t = clipf(t, F(0.0), F(1.0));
  V3 edge_x_a = vadd(p0, vscale(d1, s));
  V3 edge_x_b = vadd(q0, vscale(d2, t));
  int edge_feature = (2 << 24) | (e_i << 8) | e_j;

  out->normal = use_edge ? vneg(edge_n) : vneg(normal_ab);
  for (int slot = 0; slot < 4; ++slot) {
    float fu = pu[slot], fv = pv[slot], fh = cand_h[ip[slot]];
    V3 p_ref = vadd(face_center, vadd(vscale(u_ax, fu), vscale(v_ax, fv)));
    V3 p_inc = vadd(p_ref, vscale(n_ref, fh));
    V3 face_x_a = ref_is_a ? p_ref : p_inc;
    V3 face_x_b = ref_is_a ? p_inc : p_ref;
    int q_u = (int)clipf(floorf((fu / eu_safe + F(1.0)) * F(7.5)), F(0.0), F(15.0));
    int q_v = (int)clipf(floorf((fv / ev_safe + F(1.0)) * F(7.5)), F(0.0), F(15.0));
    int face_feat = prefix | (q_u << 4) | q_v;
    V3 xa, xb;
    int feat;
    bool ok;
    if (slot == 0) {
      xa = use_edge ? edge_x_a : face_x_a;
      xb = use_edge ? edge_x_b : face_x_b;
      feat = use_edge ? edge_feature : face_feat;
      ok = use_edge || picks_ok[0];
    } else {
      xa = face_x_a;
      xb = face_x_b;
      feat = face_feat;
      ok = picks_ok[slot] && !use_edge;
    }
    ok = ok && !separated;
    out->x_a[slot] = xa;
    out->x_b[slot] = xb;
    out->feature[slot] = ok ? feat : -1;
    out->ok[slot] = ok;
  }
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
// Phase 2a: symmetric filter + ordered precull, one thread per body.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(BLOCK) k_filter_cull(Dims dm, const int* nb, const int* key, const int* thr,
                                                       Bodies b, Work w, KParams p) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= dm.n) return;
  const int n = dm.n;
  bool precull = dm.dc < dm.d;
  V3 pos = ld3(b.pos, i, n);
  Q4 q = ld4(b.quat, i, n);
  V3 own_ax[3];
  qaxes(q, own_ax);
  V3 oh = half_at(b.size, i, n);
  float own_half[3] = {oh.x, oh.y, oh.z};
  int kept = 0, run = 0;
  for (int d = 0; d < dm.d; ++d) {
    int nbv = nb[d * n + i];
    bool valid = nbv >= 0;
    int idx = valid ? nbv : 0;
    int k = key[d * n + i];
    int qd = k / n;   // keys are non-negative: floor division
    int key_rev = qd * n + i;
    bool kept_me = key_rev <= thr[idx];
    bool partner_static = (b.inv_mass[idx] > F(0.0) ? F(1.0) : F(0.0)) < F(0.5);
    bool keep = valid && (kept_me || partner_static);
    kept += keep ? 1 : 0;
    if (w.keptmask) w.keptmask[d * n + i] = keep ? F(1.0) : F(0.0);
    int filt = keep ? nbv : -1;
    if (!precull) {
      w.nbc[d * n + i] = filt;
      continue;
    }
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
      best = fmaxf(best, sep);
    }
    bool keep2 = v2 && (best <= p.precull_margin);
    if (keep2) {
      if (run < dm.dc) w.nbc[run * n + i] = filt;
      ++run;
    }
  }
  if (precull) {
    for (int t = run; t < dm.dc; ++t) w.nbc[t * n + i] = -1;
    int dropped = run > dm.dc ? run - dm.dc : 0;
    if (dropped) atomicAdd(&w.counters[1], dropped);
  }
  if (kept) atomicAdd(&w.counters[0], kept);
}

// ---------------------------------------------------------------------------
// Phase 2b: narrowphase + warmstart match + init, one thread per (slot, body).
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(BLOCK) k_collide(Dims dm, Cache old, Cache c, Bodies b, Work w, KParams p) {
  int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = dm.n, dc = dm.dc;
  if (gid >= dc * n) return;
  int t = gid / n, i = gid - t * n;
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

  PairOut g;
  collide_pair(pa, qa, ha, pb, qb, hb, p.collision_margin, &g);
  bool slot_ok[4];
  int feature[4], count = 0;
  for (int s = 0; s < 4; ++s) {
    slot_ok[s] = g.ok[s] && valid;
    feature[s] = slot_ok[s] ? g.feature[s] : -1;
    count += g.ok[s] ? 1 : 0;
  }
  count = valid ? count : 0;

  // ---- pair match against the body's own old slots ----
  bool found = false;
  int m = 0;
  for (int dp = 0; dp < dc; ++dp) {
    bool hit = valid && (old.other[dp * n + i] == nbv) && (old.count[dp * n + i] > 0) && !found;
    if (hit) { found = true; m = dp; }
  }
  int ms = m * n + i;
  int o_count = found ? old.count[ms] : 0;
  int o_feature[4];
  bool o_stick[4];
  V3 o_ra[4], o_rb[4];
  float o_lam[12], o_pen[12];
  for (int s = 0; s < 4; ++s) {
    o_feature[s] = found ? old.feature[s * S + ms] : -1;
    o_stick[s] = old.stick[s * S + ms] > F(0.5);
    o_ra[s] = v3(old.r_a[(s * 3 + 0) * S + ms], old.r_a[(s * 3 + 1) * S + ms], old.r_a[(s * 3 + 2) * S + ms]);
    o_rb[s] = v3(old.r_b[(s * 3 + 0) * S + ms], old.r_b[(s * 3 + 1) * S + ms], old.r_b[(s * 3 + 2) * S + ms]);
  }
  for (int r = 0; r < 12; ++r) {
    o_lam[r] = old.lam[r * S + ms];
    o_pen[r] = old.pen[r * S + ms];
  }
  V3 o_normal = v3(old.normal[ms], old.normal[S + ms], old.normal[2 * S + ms]);

  V3 new_n_unit = normalize_or(g.normal, v3(F(0.0), F(1.0), F(0.0)));
  V3 old_n_unit = normalize_or(o_normal, new_n_unit);
  float normal_dot = vdot(new_n_unit, old_n_unit);

  V3 n_unit, t1, t2;
  contact_basis(g.normal, &n_unit, &t1, &t2);
  V3 old_mid[4];
  for (int s = 0; s < 4; ++s)
    old_mid[s] = vscale(vadd(vadd(pa, qrotate(qa, o_ra[s])), vadd(pb, qrotate(qb, o_rb[s]))), F(0.5));

  bool used[4] = {false, false, false, false};
  for (int s = 0; s < 4; ++s) {
    bool slot_valid = slot_ok[s];
    bool matched = false, m_stick = false;
    V3 m_mid = v3(0.f, 0.f, 0.f), m_ra = v3(0.f, 0.f, 0.f), m_rb = v3(0.f, 0.f, 0.f);
    float m_lam[3] = {0.f, 0.f, 0.f}, m_pen[3] = {0.f, 0.f, 0.f};
    for (int j = 0; j < 4; ++j) {
      bool o_ok = (j < o_count) && (o_feature[j] >= 0);
      bool elig = (o_feature[j] == feature[s]) && o_ok && !used[j] && slot_valid && !matched && found;
      if (elig) {
        matched = true;
        used[j] = true;
        m_mid = old_mid[j];
        m_stick = o_stick[j];
        m_ra = o_ra[j];
        m_rb = o_rb[j];
        for (int k = 0; k < 3; ++k) {
          m_lam[k] = o_lam[j * 3 + k];
          m_pen[k] = o_pen[j * 3 + k];
        }
      }
    }
    V3 new_ra = qrotate_inv(qa, vsub(g.x_a[s], pa));
    V3 new_rb = qrotate_inv(qb, vsub(g.x_b[s], pb));
    V3 new_mid = vscale(vadd(g.x_a[s], g.x_b[s]), F(0.5));
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
    c.feature[s * S + sl] = feature[s];
    for (int k = 0; k < 3; ++k) {
      c.lam[(s * 3 + k) * S + sl] = lam_i[k];
      c.pen[(s * 3 + k) * S + sl] = pen_i[k];
    }
  }
  c.other[sl] = count > 0 ? nbv : -1;
  c.count[sl] = count;
  c.normal[sl] = n_unit.x;
  c.normal[S + sl] = n_unit.y;
  c.normal[2 * S + sl] = n_unit.z;
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
// and T to ``fold`` (6 x tile floats after the partials) and, on a rebuild,
// the Hessian terms to w.mat.  ``own``: the constants of the thread's one
// slot where it has exactly one, else null.  Ends with the block
// synchronised.
__device__ __forceinline__ void primal_tile(const Dims& dm, const Cache& c, const Bodies& b, const Work& w,
                                            const KParams& p, int rebuild, float alpha_cur, const TileIdx& ti,
                                            float* sh, const SlotCtx* own) {
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
  float* fold = sh + N_PART * pstride;
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

// One family of joint or spring rows summed over a body's slots.
struct RowAcc {
  float F[3], T[3], ll[6], la[9], aa[6];
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
    for (int k = 0; k < 3; ++k) {
      rhs_l[k] = rhs_l[k] + acc[a].F[k];
      rhs_a[k] = rhs_a[k] + acc[a].T[k];
    }
    for (int k = 0; k < 6; ++k) {
      a_ll[k] = a_ll[k] + acc[a].ll[k];
      a_aa[k] = a_aa[k] + acc[a].aa[k];
    }
    for (int k = 0; k < 9; ++k) a_la[k] = a_la[k] + acc[a].la[k];
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
  primal_tile(dm, c, b, w, p, rebuild, alpha_cur, ti, sh, nullptr);
  primal_bodies(dm, b, w, p, ti, sh + N_PART * dm.dc * tile);
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
  SlotCtx own;
  if (one) own = slot_ctx(dm, c, b, p, i, ti.lane);
  // The start geometry has read its partner poses.
  cluster_arrive();
  if (ip.n == 0) cluster_wait();
  for (int it = 0; it < ip.n; ++it) {
    primal_tile(dm, c, b, w, p, ip.rebuild[it], ip.alpha[it], ti, sh, one ? &own : nullptr);
    // Every partner has read this body's old pose (for the start geometry
    // or in the previous sweep's dual pass) before the new one is written.
    cluster_wait();
    primal_bodies(dm, b, w, p, ti, sh + N_PART * dc * tile);
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
  float* ft;               // (6, N) contact force / torque of the sweep
};

struct JointGeom {
  float C[6];
  V3 rw_a, rw_b, rw_own;
  bool valid, is_a, is_world;
};

// joint_geometry for slot sl = t * N + i (S = DJ * N) at the poses P / Q.
__device__ __forceinline__ JointGeom joint_geometry(const JointRows& jr, int sl, int S, int i, int n,
                                                    const float* P, const float* Q) {
  JointGeom g;
  int other = jr.j_other[sl];
  g.valid = other >= 0;
  int idx = g.valid ? other : 0;
  g.is_a = jr.j_side[sl] > 0;
  g.is_world = jr.j_world[sl] > 0;
  V3 own_p = ld3(P, i, n), oth_p = ld3(P, idx, n);
  Q4 own_q = ld4(Q, i, n), oth_q = ld4(Q, idx, n);
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

// joint_force + joint_accumulate of one slot, added into acc (first slot:
// stored).
__device__ __forceinline__ void joint_slot_terms(const JointRows& jr, const JointGeom& g, int sl, int S,
                                                 bool first, RowAcc* acc) {
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
  for (int k = 0; k < 3; ++k) {
    acc->F[k] = first ? t[k] : acc->F[k] + t[k];
    acc->T[k] = first ? t[3 + k] : acc->T[k] + t[3 + k];
  }
  for (int k = 0; k < 6; ++k) acc->ll[k] = first ? t[6 + k] : acc->ll[k] + t[6 + k];
  for (int k = 0; k < 9; ++k) acc->la[k] = first ? t[12 + k] : acc->la[k] + t[12 + k];
  for (int k = 0; k < 6; ++k) acc->aa[k] = first ? t[21 + k] : acc->aa[k] + t[21 + k];
}

// spring_geometry + spring_force + spring_accumulate of one slot, added
// into acc (first slot: stored).
__device__ __forceinline__ void spring_slot_terms(const JointRows& jr, int sl, int S, int i, int n,
                                                  const float* P, const float* Q, bool first, RowAcc* acc) {
  int other = jr.s_other[sl];
  bool valid = other >= 0;
  int idx = valid ? other : 0;
  bool is_a = jr.s_side[sl] > 0;
  bool is_world = jr.s_world[sl] > 0;
  V3 own_p = ld3(P, i, n), oth_p = ld3(P, idx, n);
  Q4 own_q = ld4(Q, i, n), oth_q = ld4(Q, idx, n);
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
    float fk = sign * n3[k] * fs, tk = sign * c3[k] * fs;
    acc->F[k] = first ? fk : acc->F[k] + fk;
    acc->T[k] = first ? tk : acc->T[k] + tk;
  }
  for (int k = 0; k < 6; ++k) {
    float l = pp * n3[ij[k][0]] * n3[ij[k][1]], a = pp * c3[ij[k][0]] * c3[ij[k][1]];
    acc->ll[k] = first ? l : acc->ll[k] + l;
    acc->aa[k] = first ? a : acc->aa[k] + a;
  }
  for (int a = 0; a < 3; ++a)
    for (int k = 0; k < 3; ++k) {
      float v = pp * n3[a] * c3[k];
      acc->la[a * 3 + k] = first ? v : acc->la[a * 3 + k] + v;
    }
}

// Phase 2 decay of joint and spring rows (joint_decay, spring_decay), one
// thread per (slot, body) over max(DJ, DS) slots.
__global__ void __launch_bounds__(BLOCK) k_row_decay(Dims dm, JointRows jr, KParams p) {
  int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = dm.n;
  int t = gid / n, i = gid - t * n;
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

// Sweep with rows, part 1: the contact terms of every body, tiled as
// k_primal: F/T to jr.ft and (on a rebuild) the Hessian to w.mat.
template <int MAXT>
__global__ void __launch_bounds__(MAXT) k_contact_acc(Dims dm, Cache c, Bodies b, Work w, JointRows jr,
                                                      KParams p, int tile, int rebuild, float alpha_cur) {
  extern __shared__ float sh[];
  TileIdx ti = tile_index(tile);
  primal_tile(dm, c, b, w, p, rebuild, alpha_cur, ti, sh, nullptr);
  const float* fold = sh + N_PART * dm.dc * tile;
  for (int k = threadIdx.x; k < 6 * tile; k += blockDim.x) {
    int q = k / tile, bl = k - q * tile;
    jr.ft[q * dm.n + ti.base + bl] = fold[k];
  }
}

// Sweep with rows, part 2: colour sub-pass ci (_kernel_b_math 472-540), one
// thread per body.  Reads every pose from (src_p, src_q), evaluates the
// body's joint and spring rows there, solves, and writes the new pose of a
// body of colour ci (all bodies when there is one colour) to (dst_p,
// dst_q); other bodies are copied.  The launch boundary is the barrier
// between sub-passes, and the double buffer keeps partner reads race-free.
__global__ void __launch_bounds__(BLOCK) k_subpass(Dims dm, Bodies b, Work w, JointRows jr, KParams p, int ci,
                                                   const float* src_p, const float* src_q, float* dst_p,
                                                   float* dst_q) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= dm.n) return;
  const int n = dm.n;
  bool dyn = b.inv_mass[i] > F(0.0);
  float dynf = dyn ? F(1.0) : F(0.0);
  V3 pos = ld3(src_p, i, n);
  Q4 quat = ld4(src_q, i, n);
  float F3[3], T3[3], M[24];
  for (int k = 0; k < 3; ++k) {
    F3[k] = jr.ft[k * n + i];
    T3[k] = jr.ft[(3 + k) * n + i];
  }
  for (int q = 0; q < 24; ++q) M[q] = w.mat[q * n + i];
  RowAcc acc[2];
  int n_acc = 0;
  if (jr.dj > 0) {
    const int S = jr.dj * n;
    for (int t = 0; t < jr.dj; ++t) {
      int sl = t * n + i;
      JointGeom g = joint_geometry(jr, sl, S, i, n, src_p, src_q);
      joint_slot_terms(jr, g, sl, S, t == 0, &acc[n_acc]);
    }
    ++n_acc;
  }
  if (jr.ds > 0) {
    const int S = jr.ds * n;
    for (int t = 0; t < jr.ds; ++t) spring_slot_terms(jr, t * n + i, S, i, n, src_p, src_q, t == 0, &acc[n_acc]);
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
  st3(dst_p, i, n, new_pos);
  st4(dst_q, i, n, nq);
}

// Joint dual at the post-primal poses (joint_dual), one thread per joint
// slot; hard rows only, updated in place.
__global__ void __launch_bounds__(BLOCK) k_joint_dual(Dims dm, JointRows jr, Work w, KParams p) {
  int sl = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = dm.n, S = jr.dj * n;
  if (sl >= S) return;
  int i = sl % n;
  JointGeom g = joint_geometry(jr, sl, S, i, n, w.pos, w.quat);
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

__global__ void __launch_bounds__(BLOCK) k_final_body(Dims dm, Bodies b, Work w, KParams p) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= dm.n) return;
  const int n = dm.n;
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
    max_lin = fmaxf(max_lin, sqrtf(vdot(lv, lv)) * dynf);
    max_ang = fmaxf(max_ang, sqrtf(vdot(av, av)) * dynf);
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
        max_pen = fmaxf(max_pen, ok ? -sep : F(0.0));
        max_drift = fmaxf(max_drift, ok ? p.penetration_slop - sep : F(0.0));
        max_lam_n = fmaxf(max_lam_n, ok ? fabsf(c.lam[(s * 3) * S + sl]) : F(0.0));
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
    if (j < 8) val = v[j];
    else if (j == 8) val = (float)w.counters[2];
    else if (!with_ctrl) val = F(0.0);
    else if (j == 9) val = (float)w.counters[0];
    else if (j < 15) val = ctrl_out[j - 10];
    else if (j == 15) val = (float)w.counters[1];
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
         pl.cluster >= 0 && pl.cluster <= 16;
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
static cudaError_t launch_contact_acc_t(const SweepPlan& pl, Dims dm, Cache c, Bodies b, Work w, JointRows jr,
                                        KParams p, int rebuild, float alpha_cur, cudaStream_t st) {
  static bool ready = false;
  if (!ready) {
    cudaError_t err = opt_in(k_contact_acc<MAXT>, false);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  k_contact_acc<MAXT><<<dm.n / pl.tile, pl.threads, pl.smem, st>>>(dm, c, b, w, jr, p, pl.tile, rebuild,
                                                                   alpha_cur);
  return cudaGetLastError();
}

static cudaError_t launch_contact_acc(const SweepPlan& pl, Dims dm, Cache c, Bodies b, Work w, JointRows jr,
                                      KParams p, int rebuild, float alpha_cur, cudaStream_t st) {
  if (!plan_ok(pl, dm)) return cudaErrorInvalidValue;
  if (pl.threads <= 512) return launch_contact_acc_t<512>(pl, dm, c, b, w, jr, p, rebuild, alpha_cur, st);
  return launch_contact_acc_t<1024>(pl, dm, c, b, w, jr, p, rebuild, alpha_cur, st);
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

// Sweep it of a step's loop (solve_half's plan): alpha and the three flags.
static void step_iter(const KParams& p, int it, int n_main, int iters_end, int k, float* alpha, int* do_dual,
                      int* rebuild, int* ramp) {
  *rebuild = (it % k) == 0;
  *ramp = ((it % k) == k - 1) || (it == iters_end - 1);
  *alpha = p.post_stabilize != F(0.0) ? (it < n_main ? F(1.0) : F(0.0)) : p.alpha;
  *do_dual = it < n_main;
}

extern "C" {

// Rows of a jointed world from ptrs 54-79 (see avbd_step).
static JointRows rows_from(void** ptrs, int dj, int ds, int n_colors) {
  JointRows jr;
  jr.dj = dj;
  jr.ds = ds;
  jr.n_colors = n_colors;
  void** j = ptrs + 54;
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
  void** s = ptrs + 66;
  jr.s_other = (const int*)s[0];
  jr.s_world = (const int*)s[1];
  jr.s_side = (const int*)s[2];
  jr.s_anchor_a = (const float*)s[3];
  jr.s_anchor_b = (const float*)s[4];
  jr.s_rrest = (const float*)s[5];
  jr.s_rstiff = (const float*)s[6];
  jr.s_pen_in = (const float*)s[7];
  jr.j_lam = (float*)ptrs[74];
  jr.j_pen = (float*)ptrs[75];
  jr.s_pen = (float*)ptrs[76];
  jr.ft = (float*)ptrs[77];
  return jr;
}

// The solve of a step after its collide, shared by avbd_step (K1) and
// avbd_solve_loop (K4): prediction, slot geometry, the sweeps and the final
// velocities.  Contact-only with pl.cluster > 0: the geometry and all sweeps
// in cluster-resident launches of at most MAX_RESIDENT_ITERS sweeps (one
// launch for any scene of the repository).  Contact-only otherwise: k_geom,
// then k_primal + k_dual per sweep.  With joint or spring rows (jr.dj or
// jr.ds > 0) a sweep is k_contact_acc plus one k_subpass per colour,
// ping-ponging between w's pose buffers and pos_b/quat_b, then k_dual and
// k_joint_dual; k_joint_ema follows k_final_body.  On return w's poses are
// its output buffers again.
static cudaError_t solve_phases(const SweepPlan& pl, Dims dm, Cache c, Bodies b, Work* wp, KParams p,
                                const JointRows& jr, float* pos_b, float* quat_b, int n_main, int iters_end,
                                int k_rebuild, cudaStream_t st) {
  Work& w = *wp;
  const int n = dm.n, dj = jr.dj;
  const int nb_body = blocks_for(n), nb_slot = blocks_for(dm.dc * n);
  const bool rows = jr.dj > 0 || jr.ds > 0;
  const int k = k_rebuild < 1 ? 1 : k_rebuild;
  cudaError_t err;
  if (rows && pl.cluster > 0) return cudaErrorInvalidValue;
  k_predict<<<nb_body, BLOCK, 0, st>>>(dm, b, w, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  float* const out_pos = w.pos;
  float* const out_quat = w.quat;
  if (pl.cluster > 0) {
    const Carry none = {};
    for (int s = 0; s < iters_end || s == 0; s += MAX_RESIDENT_ITERS) {
      IterPlan ip = {};
      ip.n = iters_end - s < MAX_RESIDENT_ITERS ? iters_end - s : MAX_RESIDENT_ITERS;
      for (int j = 0; j < ip.n; ++j) {
        int do_dual, rebuild, ramp;
        step_iter(p, s + j, n_main, iters_end, k, &ip.alpha[j], &do_dual, &rebuild, &ramp);
        ip.do_dual[j] = do_dual;
        ip.rebuild[j] = rebuild;
        ip.ramp[j] = ramp;
      }
      if ((err = launch_sweeps(pl, dm, c, b, w, p, ip, s == 0, none, st)) != cudaSuccess) return err;
    }
  } else {
    k_geom<<<nb_slot, BLOCK, 0, st>>>(dm, c, w);
    for (int it = 0; it < iters_end; ++it) {
      float alpha_cur;
      int do_dual, rebuild, ramp;
      step_iter(p, it, n_main, iters_end, k, &alpha_cur, &do_dual, &rebuild, &ramp);
      if (!rows) {
        if ((err = launch_primal(pl, dm, c, b, w, p, rebuild, alpha_cur, st)) != cudaSuccess) return err;
      } else {
        // Contact terms once at the sweep-start poses, then one launch per
        // colour sub-pass, ping-ponging between the two pose buffers.
        if ((err = launch_contact_acc(pl, dm, c, b, w, jr, p, rebuild, alpha_cur, st)) != cudaSuccess) return err;
        for (int ci = 0; ci < jr.n_colors; ++ci) {
          float* dst_p = w.pos == out_pos ? pos_b : out_pos;
          float* dst_q = w.quat == out_quat ? quat_b : out_quat;
          k_subpass<<<nb_body, BLOCK, 0, st>>>(dm, b, w, jr, p, ci, w.pos, w.quat, dst_p, dst_q);
          w.pos = dst_p;
          w.quat = dst_q;
          w.snap_pos = w.pos;
          w.snap_quat = w.quat;
        }
      }
      k_dual<<<nb_slot, BLOCK, 0, st>>>(dm, c, b, w, p, do_dual, ramp, alpha_cur);
      if (dj > 0 && do_dual) k_joint_dual<<<blocks_for(dj * n), BLOCK, 0, st>>>(dm, jr, w, p);
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
  k_final_body<<<nb_body, BLOCK, 0, st>>>(dm, b, w, p);
  if (dj > 0 && p.joint_ema_rate > F(0.0)) k_joint_ema<<<blocks_for(dj * n), BLOCK, 0, st>>>(dm, jr, w, p);
  return cudaGetLastError();
}

// ptrs (in order):
//   0-11  old cache: other, count, feature, r_a, r_b, normal, stick, c0_n,
//         c0_t1, c0_t2, lam, penalty
//   12-14 nb, key, thr
//   15-28 pos, quat, size, radius, linvel, angvel, prev_linvel, mass,
//         inv_mass, friction, inertia, inv_inertia, anchor, anchor_quat
//   29-40 new cache (same order as 0-11)
//   41-46 pos, quat, linvel, angvel, prev_linvel, prev_angvel (outputs)
//   47    diag (8, 128)
//   48-52 scratch: ip (3N), iq (4N), geom (36 DC N), mat (24 N) floats;
//         nbc (DC N) ints
//   53    counters (3 ints)
// and only when dj or ds > 0 (the joint/spring branch):
//   54-65 joints: other, world, side, anchor_a, anchor_b, rest, stiff_lin,
//         stiff_ang, rmotor, lam, penalty, color
//   66-73 springs: other, world, side, anchor_a, anchor_b, rrest, rstiff,
//         penalty
//   74-76 outputs j_lam, j_pen (6 DJ N), s_pen (DS N)
//   77-79 scratch: ft (6N), second pose buffer pos (3N), quat (4N)
// ``plan``: the shape's sweep plan, 5 ints in SweepPlan order.
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
  w.keptmask = nullptr;
  w.snap_pos = w.pos;
  w.snap_quat = w.quat;
  w.blk = n;

  cudaError_t err = cudaMemsetAsync(w.counters, 0, 3 * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const bool rows = dj > 0 || ds > 0;
  JointRows jr = {};
  if (rows) {
    jr = rows_from(ptrs, dj, ds, dj > 0 ? n_colors : 1);
    k_row_decay<<<blocks_for((dj > ds ? dj : ds) * n), BLOCK, 0, st>>>(dm, jr, p);
  }
  k_filter_cull<<<blocks_for(n), BLOCK, 0, st>>>(dm, nb, key, thr, b, w, p);
  k_collide<<<blocks_for(dc * n), BLOCK, 0, st>>>(dm, old, c, b, w, p);
  err = solve_phases(pl, dm, c, b, &w, p, jr, rows ? (float*)ptrs[78] : nullptr,
                     rows ? (float*)ptrs[79] : nullptr, n_main, iters_end, k_rebuild, st);
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
  k_filter_cull<<<blocks_for(n), BLOCK, 0, st>>>(dm, (const int*)ptrs[12], (const int*)ptrs[13],
                                                 (const int*)ptrs[14], b, w, p);
  k_collide<<<blocks_for(dc * n), BLOCK, 0, st>>>(dm, old, c, b, w, p);
  return (int)cudaGetLastError();
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
// ``plan``: the shape's sweep plan, 5 ints in SweepPlan order.
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
