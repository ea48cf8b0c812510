// The fused wave-packet march (march.cuh) instantiated for float on the
// direct route (every thread reads its own row from device memory).

#include "march.cuh"

extern "C" {
SWR_MARCH_ENTRY(swr_march_f32, swr_march_batched_f32, float, ROUTE_DIRECT)
}
