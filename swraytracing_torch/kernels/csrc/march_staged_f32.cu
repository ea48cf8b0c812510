// The fused wave-packet march (march.cuh) instantiated for float on the
// staged route (each warp copies its rows into shared memory first).

#include "march.cuh"

extern "C" {
SWR_MARCH_ENTRY(swr_march_staged_f32, swr_march_batched_staged_f32, float,
                ROUTE_STAGED)
}
