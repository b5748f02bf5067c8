// Kernels A and B at capacity 16 (classes of 9 to 16 pieces per segment)
// for S = 5 and 6: the same templates as the others (kernels.cuh), with
// kMaxS per-segment slots, in a file of their own so that nvcc compiles
// them in parallel with the others.

#include "kernels.cuh"

DFT_DEFINE_OPS(16, 5)
DFT_DEFINE_OPS(16, 6)
