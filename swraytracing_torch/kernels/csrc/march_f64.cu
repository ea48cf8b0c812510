// The fused wave-packet march (march.cuh) instantiated for double on the
// direct route (every thread reads its own row from device memory).

#include "march.cuh"

extern "C" {
SWR_MARCH_ENTRY(swr_march_f64, swr_march_batched_f64, double, ROUTE_DIRECT)
}
