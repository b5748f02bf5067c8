// Kernels A and B at capacity 32 (classes with a segment of 17 to 32
// pieces) for S = 1 and 2: the same templates as the others (kernels.cuh,
// four per-segment slots), in a file of their own so that nvcc compiles
// them in parallel with the others.

#include "kernels.cuh"

DFT_DEFINE_OPS(32, 1)
DFT_DEFINE_OPS(32, 2)
