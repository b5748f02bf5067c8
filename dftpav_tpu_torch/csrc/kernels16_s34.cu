// Kernels A and B at capacity 16 (classes of 9 to 16 pieces per segment)
// for S = 3 and 4: the same templates as capacity 8 (kernels.cuh), in a
// file of their own so that nvcc compiles them in parallel with the others.

#include "kernels.cuh"

DFT_DEFINE_OPS(16, 3)
DFT_DEFINE_OPS(16, 4)
