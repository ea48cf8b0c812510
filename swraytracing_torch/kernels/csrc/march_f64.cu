// The fused wave-packet march (march.cuh) instantiated for double.

#include "march.cuh"

extern "C" int swr_march_f64(const void* p1, const void* p2, long long sp,
                             long long se, const void* xk, const void* oi,
                             const void* oj, void* out, void* ov,
                             long long np, double sub_dt, int nx, int ny,
                             double inv_dx, double inv_dy, double f2,
                             double gH, int margin, int nsub, int nf,
                             int stepper, int threads, void* stream) {
  return launch<double>(p1, p2, sp, se, xk, oi, oj, out, ov, np, sub_dt, nx, ny,
                     inv_dx, inv_dy, f2, gH, margin, nsub, nf, stepper,
                     threads, stream);
}
