"""The CUDA sources type-checked on the CPU: each csrc/*.cu, with every
kernel it instantiates, compiled by g++ -fsyntax-only against a stand-in
for the CUDA runtime's header.

The host has no nvcc, so a template or signature slip in csrc/ would
otherwise show first in the card's build. Here the sources are read as the
host compiler reads them (__CUDACC__ defined, so the warp team and the
kernels' bodies are compiled too); the stand-in declares the runtime's
types, attributes and intrinsics, and the launch configurations (<<<...>>>)
are cut from a copy of the sources. Nothing runs: what only the device
compiler refuses, and every number, still needs the card (chip_smoke.py).
Skips where g++ is absent.
"""

import re
import shutil
import subprocess

import pytest

from dftpav_tpu_torch.ops import _cuda

STUB = r"""
#pragma once
#include <cmath>
#include <cstddef>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(a, b)
#define __align__(n) __attribute__((aligned(n)))
struct uint3 { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
extern uint3 threadIdx, blockIdx, blockDim, gridDim;
inline void __syncthreads() {}
inline void __syncwarp() {}
template <class T> T __shfl_sync(unsigned, T v, int) { return v; }
template <class T> T __shfl_xor_sync(unsigned, T v, int) { return v; }
inline unsigned __ballot_sync(unsigned, int p) { return p; }
inline int atomicAdd(int* p, int v) { int o = *p; *p += v; return o; }
using std::isfinite;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorInvalidConfiguration = 9 };
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin,
                      cudaDevAttrMultiProcessorCount };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
inline cudaError_t cudaGetDevice(int*) { return 0; }
inline cudaError_t cudaDeviceGetAttribute(int*, cudaDeviceAttr, int) {
  return 0;
}
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, K, int,
                                                          size_t) {
  return 0;
}
template <class K>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes*, K) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaMemsetAsync(void*, int, size_t, cudaStream_t) {
  return 0;
}
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
"""

SOURCES = sorted(p.name for p in _cuda.CSRC.glob("*.cu"))


@pytest.fixture(scope="module")
def host_copy(tmp_path_factory):
    """The sources with their launch configurations cut, and the stand-in
    header, in a directory of their own."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available to type-check the CUDA sources")
    out = tmp_path_factory.mktemp("csrc_host")
    for src in list(_cuda.CSRC.glob("*.cu")) + list(_cuda.CSRC.glob("*.cuh")):
        (out / src.name).write_text(re.sub(r"<<<.*?>>>", "",
                                           src.read_text()))
    (out / "cuda_runtime.h").write_text(STUB)
    return gxx, out


def test_every_source_is_checked():
    """The kernel sources the library is built from, those of S = 5 to 8
    and of capacity 32 included."""
    assert {"kernels.cu", "kernels8_s56.cu", "kernels8_s78.cu",
            "kernels16_s56.cu", "kernels16_s78.cu", "kernels32_s12.cu",
            "kernels32_s34.cu", "kernels32_s56.cu", "kernels32_s78.cu",
            "penalty.cu"} <= set(SOURCES)


@pytest.mark.parametrize("name", SOURCES)
def test_source_type_checks(host_copy, name):
    gxx, out = host_copy
    proc = subprocess.run(
        [gxx, "-std=c++17", "-fsyntax-only", "-D__CUDACC__",
         "-Wno-unknown-pragmas", "-I", str(out), "-x", "c++",
         str(out / name)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
