// The fused wave-packet march (march.cuh) instantiated for double on the
// ring route (march_ring.cuh: producer warps copy the rows into a ring of
// shared-memory slots while consumer warps march).

#include "march_ring.cuh"

extern "C" {
SWR_MARCH_ENTRY(swr_march_ring_f64, swr_march_batched_ring_f64, double,
                ROUTE_RING)
}
