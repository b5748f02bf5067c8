// Kernels A and B at capacity 32 (classes with a segment of 17 to 32
// pieces) for S = 7 and 8: the same templates as the others (kernels.cuh,
// kMaxS per-segment slots), in a file of their own so that nvcc compiles
// them in parallel with the others.

#include "kernels.cuh"

DFT_DEFINE_OPS(32, 7)
DFT_DEFINE_OPS(32, 8)
