// Kernels A and B at capacity 8 (classes of 2 to 8 pieces per segment) for
// S = 3 and 4, in a file of their own so that nvcc compiles them in
// parallel with the others (kernels.cuh).

#include "kernels.cuh"

DFT_DEFINE_OPS(8, 3)
DFT_DEFINE_OPS(8, 4)
