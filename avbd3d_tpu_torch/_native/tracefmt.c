/*
 * tracefmt.c — native formatter for the headless per-step body dump.
 *
 * The reference prints every body's state every step in its headless mode
 * (main.cpp:228-234); at 1000 bodies that printf loop is the host-side
 * bottleneck of trace mode.  This formats the identical byte layout
 * directly from the simulation's float32 buffers, newest body first
 * (the reference body list is LIFO).
 *
 * Plain C ABI (no Python.h) so it loads via ctypes; built on demand by
 * avbd3d_tpu_torch/utils/native.py.
 */

#include <stdio.h>

/* Format bodies [0, n_real) in reverse order into out (capacity cap).
 * pos/linvel/angvel: n x 3 float32 row-major; quat: n x 4 (x,y,z,w).
 * Returns bytes written, or -1 if the buffer is too small. */
long avbd_format_step(long step_idx,
                      const float *pos, const float *quat,
                      const float *linvel, const float *angvel,
                      long n_real, char *out, long cap) {
    long w = 0;
    int k = snprintf(out + w, (size_t)(cap - w), "Step %ld:\n", step_idx);
    if (k < 0 || w + k >= cap) return -1;
    w += k;
    for (long i = n_real - 1; i >= 0; --i) {
        const float *p = pos + 3 * i;
        const float *q = quat + 4 * i;
        const float *lv = linvel + 3 * i;
        const float *av = angvel + 3 * i;
        k = snprintf(out + w, (size_t)(cap - w),
                     "  Body %ld: Pos(%.4f, %.4f, %.4f)  "
                     "Rot(%.4f, %.4f, %.4f, %.4f)  "
                     "LinVel(%.4f, %.4f, %.4f)  AngVel(%.4f, %.4f, %.4f)\n",
                     i + 1,
                     p[0], p[1], p[2],
                     q[0], q[1], q[2], q[3],
                     lv[0], lv[1], lv[2],
                     av[0], av[1], av[2]);
        if (k < 0 || w + k >= cap) return -1;
        w += k;
    }
    return w;
}
