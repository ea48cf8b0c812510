// The fused wave-packet march (march.cuh) instantiated for double on the
// staged route (each warp copies its rows into shared memory first).

#include "march.cuh"

extern "C" {
SWR_MARCH_ENTRY(swr_march_staged_f64, swr_march_batched_staged_f64, double,
                ROUTE_STAGED)
}
