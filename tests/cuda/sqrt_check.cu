// Exhaustive card check: the kernels' branch-free float square root
// (ellipse_tile.cu: sqrt_rn, pairwise_tile.cu: sqrt_t) equals __fsqrt_rn
// bit for bit, NaN for NaN, over all 2^32 inputs. The kernel source is
// included whole, so the function checked is the one the kernels inline.
// Built by tests/test_torch_cuda.py with the kernels' nvcc flags, plus
// -DCHECK_PAIRWISE for pairwise_tile.cu.

#ifdef CHECK_PAIRWISE
#include "../../glomargridding_tpu_torch/ops/cuda/csrc/pairwise_tile.cu"
#define SQRT_UNDER_TEST sqrt_t
#else
#include "../../glomargridding_tpu_torch/ops/cuda/csrc/ellipse_tile.cu"
#define SQRT_UNDER_TEST sqrt_rn
#endif

namespace {

__global__ void sqrt_check_kernel(unsigned long long* mismatches) {
  unsigned long long local = 0;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = blockIdx.x * static_cast<uint64_t>(blockDim.x) + threadIdx.x;
       i < (1ull << 32); i += stride) {
    const float x = __uint_as_float(static_cast<unsigned>(i));
    const float a = SQRT_UNDER_TEST(x), b = __fsqrt_rn(x);
    local += !((isnan(a) && isnan(b)) || __float_as_uint(a) == __float_as_uint(b));
  }
  atomicAdd(mismatches, local);
}

}  // namespace

// mismatches: one zeroed uint64 on the card; returns the launch's cudaError_t.
extern "C" int sqrt_check(void* mismatches) {
  sqrt_check_kernel<<<1024, 256>>>(static_cast<unsigned long long*>(mismatches));
  return cudaGetLastError();
}
