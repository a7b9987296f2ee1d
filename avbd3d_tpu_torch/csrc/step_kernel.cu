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
// memory and every sweep re-reads it from L2.  A Jacobi sweep needs every
// body's new pose before any dual update (solver_tpu.py:543-548), i.e. a
// grid-wide barrier between the primal and the dual half.  A single
// 1024-thread block would cap registers at 64 per thread and spill the
// 6x6 solve and the SAT; a cooperative grid.sync() kernel would carry the
// register pressure of its largest phase through all of them.  This design
// takes the simplest barrier: one launch per phase, queued back to back from
// the host entry point on one stream, 2 launches per sweep (~47 per step).
//   k_filter_cull   1 thread / body         symmetric filter + ordered precull
//   k_collide       1 thread / (slot, body) SAT, warmstart match, row init
//   k_predict       1 thread / body         prediction
//   k_geom          1 thread / (slot, body) geometry at the predicted poses
//   per sweep:
//     k_primal      1 thread / body         rows, force, 6x6 (rebuilt at block
//                                           heads), solve66, relaxed update
//     k_dual        1 thread / (slot, body) geometry at the new poses, dual
//                                           update, ramp at block tails
//   k_final_body    1 thread / body         sanitize, velocities
//   k_final_reduce  1 block                 diagnostics lanes + control lanes
// The iteration count and the Hessian cadence are runtime arguments, so the
// calm, fresh and boosted variants share this code.
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
// Geometry at the current working poses (geometry_pose), one thread per slot.
// Writes rw_a, rw_b, sep, slip1, slip2 of the slot's four contacts.
// ---------------------------------------------------------------------------

struct SlotGeom {
  V3 rw_a[4], rw_b[4];
  float sep[4], slip1[4], slip2[4];
};

__device__ __forceinline__ void slot_geometry(const Cache& c, const Work& w, int i, int idx, bool is_a,
                                              int sl, int S, int n, V3 nu, V3 t1, V3 t2, SlotGeom* gm) {
  bool same_block = (idx / w.blk) == (i / w.blk);
  const float* pp = same_block ? w.pos : w.snap_pos;
  const float* pq = same_block ? w.quat : w.snap_quat;
  V3 own_p = ld3(w.pos, i, n), oth_p = ld3(pp, idx, n);
  Q4 own_q = ld4(w.quat, i, n), oth_q = ld4(pq, idx, n);
  V3 pa = is_a ? own_p : oth_p, pb = is_a ? oth_p : own_p;
  Q4 qa = is_a ? own_q : oth_q, qb = is_a ? oth_q : own_q;
  for (int s = 0; s < 4; ++s) {
    V3 ra = qrotate(qa, v3(c.r_a[(s * 3) * S + sl], c.r_a[(s * 3 + 1) * S + sl], c.r_a[(s * 3 + 2) * S + sl]));
    V3 rb = qrotate(qb, v3(c.r_b[(s * 3) * S + sl], c.r_b[(s * 3 + 1) * S + sl], c.r_b[(s * 3 + 2) * S + sl]));
    V3 delta = vsub(vadd(pa, ra), vadd(pb, rb));
    gm->rw_a[s] = ra;
    gm->rw_b[s] = rb;
    gm->sep[s] = vdot(delta, nu);
    gm->slip1[s] = vdot(delta, t1);
    gm->slip2[s] = vdot(delta, t2);
  }
}

__device__ __forceinline__ void store_geom(float* g, int sl, int S, const SlotGeom& gm) {
  for (int s = 0; s < 4; ++s) {
    g[(s * 3 + 0) * S + sl] = gm.rw_a[s].x;
    g[(s * 3 + 1) * S + sl] = gm.rw_a[s].y;
    g[(s * 3 + 2) * S + sl] = gm.rw_a[s].z;
    g[(12 + s * 3 + 0) * S + sl] = gm.rw_b[s].x;
    g[(12 + s * 3 + 1) * S + sl] = gm.rw_b[s].y;
    g[(12 + s * 3 + 2) * S + sl] = gm.rw_b[s].z;
    g[(24 + s) * S + sl] = gm.sep[s];
    g[(28 + s) * S + sl] = gm.slip1[s];
    g[(32 + s) * S + sl] = gm.slip2[s];
  }
}

__device__ __forceinline__ void load_geom(const float* g, int sl, int S, SlotGeom* gm) {
  for (int s = 0; s < 4; ++s) {
    gm->rw_a[s] = v3(g[(s * 3) * S + sl], g[(s * 3 + 1) * S + sl], g[(s * 3 + 2) * S + sl]);
    gm->rw_b[s] = v3(g[(12 + s * 3) * S + sl], g[(12 + s * 3 + 1) * S + sl], g[(12 + s * 3 + 2) * S + sl]);
    gm->sep[s] = g[(24 + s) * S + sl];
    gm->slip1[s] = g[(28 + s) * S + sl];
    gm->slip2[s] = g[(32 + s) * S + sl];
  }
}

__global__ void __launch_bounds__(BLOCK) k_geom(Dims dm, Cache c, Work w) {
  int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = dm.n, S = dm.dc * dm.n;
  if (gid >= S) return;
  int i = gid % n;
  int other = c.other[gid];
  int idx = other >= 0 ? other : 0;
  V3 nu, t1, t2;
  contact_basis(v3(c.normal[gid], c.normal[S + gid], c.normal[2 * S + gid]), &nu, &t1, &t2);
  SlotGeom gm;
  slot_geometry(c, w, i, idx, i < idx, gid, S, n, nu, t1, t2, &gm);
  store_geom(w.geom, gid, S, gm);
}

// ---------------------------------------------------------------------------
// Phase 4a: primal pass, one thread per body.
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

__global__ void __launch_bounds__(BLOCK) k_primal(Dims dm, Cache c, Bodies b, Work w, KParams p, int rebuild,
                                                  float alpha_cur) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= dm.n) return;
  const int n = dm.n, S = dm.dc * dm.n;
  const float bias = clipf(F(1.0) - alpha_cur, F(0.0), F(1.0));
  bool dyn = b.inv_mass[i] > F(0.0);
  float dynf = dyn ? F(1.0) : F(0.0);
  V3 pos = ld3(w.pos, i, n);
  Q4 quat = ld4(w.quat, i, n);

  float iiw[6];
  world_inertia(quat, ld3(b.inv_inertia, i, n), iiw);
  float F3[3] = {0.f, 0.f, 0.f}, T3[3] = {0.f, 0.f, 0.f};
  float M[24];
  for (int k = 0; k < 24; ++k) M[k] = F(0.0);

  for (int t = 0; t < dm.dc; ++t) {
    int sl = t * n + i;
    int other = c.other[sl];
    bool valid = other >= 0;
    int idx = valid ? other : 0;
    bool is_a = i < idx;
    float sign = is_a ? F(1.0) : F(-1.0);
    float mu, mass_scale;
    pair_consts(b, i, idx, &mu, &mass_scale);
    float cap = p.normal_force_cap * mass_scale;
    V3 basis[3];
    contact_basis(v3(c.normal[sl], c.normal[S + sl], c.normal[2 * S + sl]), &basis[0], &basis[1], &basis[2]);
    int count = c.count[sl];
    SlotGeom gm;
    load_geom(w.geom, sl, S, &gm);

    float Fd[6];     // F (3) and T (3) of this slot, summed over its contacts
    float Md[24];    // Hessian terms of this slot, summed over its 12 rows
    for (int s = 0; s < 4; ++s) {
      bool slot_ok = (s < count) && valid;
      float lam[3], pen[3];
      for (int k = 0; k < 3; ++k) {
        lam[k] = c.lam[(s * 3 + k) * S + sl];
        pen[k] = c.pen[(s * 3 + k) * S + sl];
      }
      bool stick = c.stick[s * S + sl] > F(0.5);
      Rows3 r = eval_rows3(gm.sep[s], gm.slip1[s], gm.slip2[s], c.c0_n[s * S + sl], c.c0_t1[s * S + sl],
                           c.c0_t2[s * S + sl], lam, pen, stick, slot_ok, mu, cap, bias, p);
      float f[3];
      for (int k = 0; k < 3; ++k) {
        f[k] = slot_ok ? clipf(pen[k] * r.C[k] + r.lam[k], r.fmin[k], r.fmax[k]) : F(0.0);
        // The dual pass reads the projected lambda and the new latch.
        c.lam[(s * 3 + k) * S + sl] = r.lam[k];
      }
      c.stick[s * S + sl] = r.stick ? F(1.0) : F(0.0);

      V3 rw = is_a ? gm.rw_a[s] : gm.rw_b[s];
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
          bool first = (s == 0) && (k == 0);
          for (int q = 0; q < 24; ++q) Md[q] = first ? term[q] : Md[q] + term[q];
        }
      }
    }
    for (int k = 0; k < 3; ++k) {
      F3[k] = t == 0 ? Fd[k] : F3[k] + Fd[k];
      T3[k] = t == 0 ? Fd[3 + k] : T3[k] + Fd[3 + k];
    }
    if (rebuild)
      for (int q = 0; q < 24; ++q) M[q] = t == 0 ? Md[q] : M[q] + Md[q];
  }
  if (rebuild) {
    for (int q = 0; q < 24; ++q) w.mat[q * n + i] = M[q];
  } else {
    for (int q = 0; q < 24; ++q) M[q] = w.mat[q * n + i];
  }
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
  float a_aa[6] = {m_aa[0] + iw[0] * p.inv_dt2 + gyro[0], m_aa[1] + iw[1] * p.inv_dt2,
                   m_aa[2] + iw[2] * p.inv_dt2, m_aa[3] + iw[3] * p.inv_dt2 + gyro[1],
                   m_aa[4] + iw[4] * p.inv_dt2, m_aa[5] + iw[5] * p.inv_dt2 + gyro[2]};
  float dl[3], da[3];
  solve66(a_ll, m_la, a_aa, rhs_l, rhs_a, dl, da);

  const float relax = p.relaxation;
  V3 new_pos = v3(pos.x - relax * dl[0] * dynf, pos.y - relax * dl[1] * dynf, pos.z - relax * dl[2] * dynf);
  Q4 dq = qmul(Q4{da[0] * relax, da[1] * relax, da[2] * relax, F(0.0)}, quat);
  Q4 nq = q_normalize(Q4{quat.x - F(0.5) * dq.x, quat.y - F(0.5) * dq.y, quat.z - F(0.5) * dq.z,
                         quat.w - F(0.5) * dq.w});
  nq = dyn ? nq : quat;
  st3(w.pos, i, n, new_pos);
  st4(w.quat, i, n, nq);
}

// ---------------------------------------------------------------------------
// Phase 4b: geometry at the new poses + dual update, one thread per slot.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(BLOCK) k_dual(Dims dm, Cache c, Bodies b, Work w, KParams p, int do_dual,
                                                int ramp, float alpha_cur) {
  int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = dm.n, S = dm.dc * dm.n;
  if (gid >= S) return;
  int i = gid % n;
  int sl = gid;
  const float bias = clipf(F(1.0) - alpha_cur, F(0.0), F(1.0));
  int other = c.other[sl];
  bool valid = other >= 0;
  int idx = valid ? other : 0;
  bool is_a = i < idx;
  float mu, mass_scale;
  pair_consts(b, i, idx, &mu, &mass_scale);
  float cap = p.normal_force_cap * mass_scale;
  V3 basis[3];
  contact_basis(v3(c.normal[sl], c.normal[S + sl], c.normal[2 * S + sl]), &basis[0], &basis[1], &basis[2]);
  SlotGeom gm;
  slot_geometry(c, w, i, idx, is_a, sl, S, n, basis[0], basis[1], basis[2], &gm);
  store_geom(w.geom, sl, S, gm);
  int count = c.count[sl];
  for (int s = 0; s < 4; ++s) {
    bool slot_ok = (s < count) && valid;
    float lam[3], pen[3];
    for (int k = 0; k < 3; ++k) {
      lam[k] = c.lam[(s * 3 + k) * S + sl];
      pen[k] = c.pen[(s * 3 + k) * S + sl];
    }
    bool stick = c.stick[s * S + sl] > F(0.5);
    Rows3 r = eval_rows3(gm.sep[s], gm.slip1[s], gm.slip2[s], c.c0_n[s * S + sl], c.c0_t1[s * S + sl],
                         c.c0_t2[s * S + sl], lam, pen, stick, slot_ok, mu, cap, bias, p);
    for (int k = 0; k < 3; ++k) {
      float out_lam, out_pen = pen[k];
      if (do_dual) {
        V3 ja_a = vcross(gm.rw_a[s], basis[k]);
        V3 ja_b = vcross(gm.rw_b[s], basis[k]);
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

__global__ void __launch_bounds__(CTRL_THREADS) k_final_reduce(Dims dm, Cache c, Bodies b, Work w, KParams p,
                                                               CtrlIn ctrl) {
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
  float ctrl_out[5];
  __shared__ float ctrl_sh[5];
  control_lanes_block(ctrl, p, ctrl_sh, sh);
  __syncthreads();
  for (int k = 0; k < 5; ++k) ctrl_out[k] = ctrl_sh[k];
  for (int j = threadIdx.x; j < 8 * 128; j += blockDim.x) {
    float val = F(0.0);
    if (j < 8) val = v[j];
    else if (j == 8) val = (float)w.counters[2];
    else if (j == 9) val = (float)w.counters[0];
    else if (j < 15) val = ctrl_out[j - 10];
    else if (j == 15) val = (float)w.counters[1];
    w.diag[j] = val;
  }
}

// ---------------------------------------------------------------------------
// Host entry point
// ---------------------------------------------------------------------------

extern "C" {

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
// Returns the first non-zero CUDA error code, or 0.
int avbd_step(void** ptrs, const float* params, int n, int d, int dc, int n_main, int iters_end,
              int k_rebuild, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dc > d || n % 128 != 0) return (int)cudaErrorInvalidValue;
  KParams p = *(const KParams*)params;
  Dims dm{n, d, dc};
  Cache old, c;
  Cache* cs[2] = {&old, &c};
  for (int q = 0; q < 2; ++q) {
    void** a = ptrs + (q == 0 ? 0 : 29);
    cs[q]->other = (int*)a[0];
    cs[q]->count = (int*)a[1];
    cs[q]->feature = (int*)a[2];
    cs[q]->r_a = (float*)a[3];
    cs[q]->r_b = (float*)a[4];
    cs[q]->normal = (float*)a[5];
    cs[q]->stick = (float*)a[6];
    cs[q]->c0_n = (float*)a[7];
    cs[q]->c0_t1 = (float*)a[8];
    cs[q]->c0_t2 = (float*)a[9];
    cs[q]->lam = (float*)a[10];
    cs[q]->pen = (float*)a[11];
  }
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
  const int nb_body = blocks_for(n), nb_slot = blocks_for(dc * n);
  k_filter_cull<<<nb_body, BLOCK, 0, st>>>(dm, nb, key, thr, b, w, p);
  k_collide<<<nb_slot, BLOCK, 0, st>>>(dm, old, c, b, w, p);
  k_predict<<<nb_body, BLOCK, 0, st>>>(dm, b, w, p);
  k_geom<<<nb_slot, BLOCK, 0, st>>>(dm, c, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int k = k_rebuild < 1 ? 1 : k_rebuild;
  for (int it = 0; it < iters_end; ++it) {
    int rebuild = (it % k) == 0;
    int ramp = ((it % k) == k - 1) || (it == iters_end - 1);
    float alpha_cur = p.post_stabilize != F(0.0) ? (it < n_main ? F(1.0) : F(0.0)) : p.alpha;
    k_primal<<<nb_body, BLOCK, 0, st>>>(dm, c, b, w, p, rebuild, alpha_cur);
    k_dual<<<nb_slot, BLOCK, 0, st>>>(dm, c, b, w, p, it < n_main, ramp, alpha_cur);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  k_final_body<<<nb_body, BLOCK, 0, st>>>(dm, b, w, p);
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
  k_final_reduce<<<1, CTRL_THREADS, 0, st>>>(dm, c, b, w, p, ctrl);
  return (int)cudaGetLastError();
}

}  // extern "C"
