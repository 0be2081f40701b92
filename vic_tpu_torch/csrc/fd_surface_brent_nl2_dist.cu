// K7 fd_surface_brent's instances for 2 soil layers, DIST_PRCP's dry column (fd_surface_brent.cuh;
// the entry is fd_surface_brent.cu), built apart so nvcc compiles the
// eight instances four at a time.

#include "fd_surface_brent.cuh"

template int vicfd::launch<2, true>(const LaneInputs&,
                                     const vicfd::SweepArgs&,
                                     const vicfd::BrentArgs&, int,
                                     cudaStream_t);
