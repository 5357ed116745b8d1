// The ellipse fit's Fisher-z objective over a stacked call of points (K5)
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel of glomargridding_tpu: there the objective is
// plain jnp under vmap (models/ellipse/model.py:_nll_fit_z), which XLA
// fuses. In the port it ran as ~30 of PyTorch's elementwise kernels a
// call, each writing a (K, B, N) f32 intermediate and the next reading it
// back, over every lane whether the simplex still used it or not: 97% of
// the 1-degree fit's device time, ~100x the bytes of one pass over the
// lanes' data. This kernel computes, for K points of each of B lanes,
//
//   out[k, b] = sum_j w_bj (z_bj - atanh(clip(m_k(X_bj)))) ^ 2 / (2 s_k^2)
//             + (log s_k + log sqrt(2 pi)) sum_j w_bj,
//
// with m_k the anisotropic Matern correlation of point k (Lx, Ly[, theta]
// [, sigma]) at the displacement X_bj, zero where w_bj <= 0 or its value
// is NaN: EllipseModel._nll_fit_z of every point and lane, as
// torch.func.vmap lifts it, in one launch.
//
// What bounds it on the H100. A call reads each lane's data once, 16 B a
// (lane, column) in f32 (X, z, w): 0.040 ms at 2,048 x 4,096 and 3.35 TB/s.
// The arithmetic is ~80 instructions an (element, point) (the quadratic
// form, a sqrt, the exp and Horner, the clip, atanhf, the weighted square,
// the f64 add): at K = 4, ~0.09 ms of issue at the full card. So a full
// call is issue-bound by ~2x; and most calls of a fit carry few lanes.
//
// Design:
//  * One block a lane. A lane outside the caller's mask (one the simplex
//    has stopped, or one that does not shrink) writes +inf and reads
//    nothing, so a call costs what its live lanes need.
//  * The block computes each point's Sigma^-1 entries, 1 / sigma and
//    log sigma once (threads 0..K-1, through shared memory); then each
//    thread walks its columns with 16-byte loads (4 f32 or 2 f64 columns,
//    neighbouring threads on neighbouring columns) and evaluates all K
//    points from registers: no (K, B, N) intermediate exists.
//  * Every f32 operation is written rounded (__fmul_rn and kin), so nvcc
//    contracts nothing into an FMA, in the order the plain twin's kernels
//    take them: the f32 terms are the twin's, op for op, and the
//    simplex, which compares values that differ in their last bits,
//    walks as it does on the twin. Built without --use_fast_math: expf,
//    atanhf, sqrtf and logf are the precise library functions.
//  * Each term is added into a float64 accumulator per point, and the
//    block reduces them in float64 in a fixed order (warp shuffles, then
//    shared memory): no atomics, so a call gives the same bits every
//    time. The sum of the weights and the log sigma term are added in
//    float64 at the end, as _weighted_nll does.
//
// Templates: T in {float, double}; K, the points a call, 1..5 (d + 1 for
// the widest form, three shape parameters and sigma); NC, the Horner
// coefficients, 1..4 (nu = 0.5 .. 3.5).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxPoints = 5;
constexpr int kMaxCoeffs = 4;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; static constexpr int kLen = 4; };
template <> struct Vec16<double> { using type = double2; static constexpr int kLen = 2; };

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float atanh_t(float x) { return atanhf(x); }
__device__ __forceinline__ double atanh_t(double x) { return atanh(x); }
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }
__device__ __forceinline__ float sin_t(float x) { return sinf(x); }
__device__ __forceinline__ double sin_t(double x) { return sin(x); }
__device__ __forceinline__ float cos_t(float x) { return cosf(x); }
__device__ __forceinline__ double cos_t(double x) { return cos(x); }

// The model's constants, rounded to T once, as the twin's Python floats
// are where they meet a T tensor.
template <typename T>
struct Consts {
  T first;         // 1 / (Gamma(nu) 2^(nu - 1))
  T root_half_pi;  // sqrt(pi / 2)
  T sqrt_v;        // sqrt(nu)
  T threshold;     // the Fisher clip, ARCTANH_THRESHOLD
  T coeffs[kMaxCoeffs];  // Horner, from x^n down (special.half_integer_coeffs)
  double log_sqrt_2pi;   // added to log sigma in float64
};

// One point's values for the column loop: Sigma^-1 (i10 == i01) and 1 / sigma.
template <typename T>
struct Inv {
  T i00, i01, i11, inv_sigma;
};

// distances.sigma_rot_flat and mahal_dist_func's inverse for one point,
// in the twin's order; sigma is 1 for the unit-sigma forms.
template <typename T>
__device__ void point_values(const T* p, int n_shape, int fit_sigma,
                             double log_sqrt_2pi, Inv<T>* inv,
                             double* offset) {
  const T Lx = p[0], Ly = p[1];
  const T Lx2 = mul_rn(Lx, Lx), Ly2 = mul_rn(Ly, Ly);
  T s00, s01, s11;
  if (n_shape == 3) {
    const T ct = cos_t(p[2]), st = sin_t(p[2]);
    const T c2 = mul_rn(ct, ct), s2 = mul_rn(st, st), cs = mul_rn(ct, st);
    s00 = add_rn(mul_rn(c2, Lx2), mul_rn(s2, Ly2));
    s01 = mul_rn(cs, sub_rn(Lx2, Ly2));
    s11 = add_rn(mul_rn(s2, Lx2), mul_rn(c2, Ly2));
  } else {
    s00 = Lx2;
    s01 = T(0);
    s11 = Ly2;
  }
  const T det = sub_rn(mul_rn(s00, s11), mul_rn(s01, s01));
  inv->i00 = div_rn(s11, det);
  inv->i01 = div_rn(-s01, det);
  inv->i11 = div_rn(s00, det);
  const T sigma = fit_sigma ? p[n_shape] : T(1);
  inv->inv_sigma = div_rn(T(1), sigma);
  *offset = double(log_t(sigma)) + log_sqrt_2pi;
}

// One column's term for one point, as _masked_model_z and _weighted_nll
// compute it (the weight's test and the NaN guard as selects).
template <typename T, int NC>
__device__ __forceinline__ T term(const Inv<T>& s, const Consts<T>& c, T dx,
                                  T dy, T zo, T wt) {
  T q = add_rn(mul_rn(dx, add_rn(mul_rn(dx, s.i00), mul_rn(dy, s.i01))),
               mul_rn(dy, add_rn(mul_rn(dx, s.i01), mul_rn(dy, s.i11))));
  q = q < T(0) ? T(0) : q;  // clamp(q, min=0): NaN stays NaN
  const T x = mul_rn(mul_rn(T(2), sqrt_t(q)), c.sqrt_v);
  T h = c.coeffs[0];
#pragma unroll
  for (int j = 1; j < NC; ++j) h = add_rn(mul_rn(h, x), c.coeffs[j]);
  T y = mul_rn(c.first, mul_rn(mul_rn(c.root_half_pi, exp_t(-x)), h));
  y = (wt > T(0) && x > T(0) && !isnan(y)) ? y : T(0);
  y = y < -c.threshold ? -c.threshold : (y > c.threshold ? c.threshold : y);
  const T r = mul_rn(sub_rn(zo, atanh_t(y)), s.inv_sigma);
  return mul_rn(mul_rn(mul_rn(T(0.5), r), r), wt);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int K, int NC>
__global__ void __launch_bounds__(kMaxThreads)
fisher_z_nll_kernel(const T* __restrict__ points,  // (K, B, d)
                    const T* __restrict__ X,       // (B, N, 2)
                    const T* __restrict__ z,       // (B, N)
                    const T* __restrict__ w,       // (B, N)
                    const uint8_t* __restrict__ mask,  // (B,)
                    int64_t B, int64_t N, int d, int n_shape, int fit_sigma,
                    int vec, Consts<T> c, double* __restrict__ out) {
  const int64_t b = blockIdx.x;
  if (!mask[b]) {
    if (threadIdx.x < K) out[threadIdx.x * B + b] = INFINITY;
    return;
  }
  __shared__ Inv<T> s_inv[K];
  __shared__ double s_offset[K];
  __shared__ double s_red[kMaxWarps][K + 1];
  if (threadIdx.x < K) {
    point_values(points + (threadIdx.x * B + b) * d, n_shape, fit_sigma,
                 c.log_sqrt_2pi, &s_inv[threadIdx.x], &s_offset[threadIdx.x]);
  }
  __syncthreads();
  Inv<T> inv[K];
#pragma unroll
  for (int k = 0; k < K; ++k) inv[k] = s_inv[k];

  double acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0;
  double sw = 0.0;
  const T* Xb = X + b * N * 2;
  const T* zb = z + b * N;
  const T* wb = w + b * N;
  if (vec) {
    // N % kLen == 0 and every row 16-byte aligned (the wrapper checks)
    using V = typename Vec16<T>::type;
    constexpr int kLen = Vec16<T>::kLen;
    for (int64_t j = int64_t(threadIdx.x) * kLen; j < N;
         j += int64_t(blockDim.x) * kLen) {
      T xs[2 * kLen], zs[kLen], ws[kLen];
      *reinterpret_cast<V*>(xs) = *reinterpret_cast<const V*>(Xb + 2 * j);
      *reinterpret_cast<V*>(xs + kLen) =
          *reinterpret_cast<const V*>(Xb + 2 * j + kLen);
      *reinterpret_cast<V*>(zs) = *reinterpret_cast<const V*>(zb + j);
      *reinterpret_cast<V*>(ws) = *reinterpret_cast<const V*>(wb + j);
#pragma unroll
      for (int i = 0; i < kLen; ++i) {
        sw += double(ws[i]);
#pragma unroll
        for (int k = 0; k < K; ++k)
          acc[k] += double(term<T, NC>(inv[k], c, xs[2 * i], xs[2 * i + 1],
                                       zs[i], ws[i]));
      }
    }
  } else {
    for (int64_t j = threadIdx.x; j < N; j += blockDim.x) {
      const T dx = Xb[2 * j], dy = Xb[2 * j + 1], zo = zb[j], wt = wb[j];
      sw += double(wt);
#pragma unroll
      for (int k = 0; k < K; ++k)
        acc[k] += double(term<T, NC>(inv[k], c, dx, dy, zo, wt));
    }
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = warp_sum(acc[k]);
  sw = warp_sum(sw);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) s_red[warp][k] = acc[k];
    s_red[warp][K] = sw;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    const int k = threadIdx.x, warps = blockDim.x / 32;
    double data = 0.0, count = 0.0;
    for (int i = 0; i < warps; ++i) {
      data += s_red[i][k];
      count += s_red[i][K];
    }
    out[k * B + b] = data + count * s_offset[k];
  }
}

template <typename T, int K>
cudaError_t launch_nc(int nc, const void* points, const void* X,
                      const void* z, const void* w, const uint8_t* mask,
                      int64_t B, int64_t N, int d, int n_shape, int fit_sigma,
                      int vec, const Consts<T>& c, double* out, int threads,
                      cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(B));
#define K5_LAUNCH(NC)                                                       \
  fisher_z_nll_kernel<T, K, NC><<<grid, threads, 0, s>>>(                   \
      static_cast<const T*>(points), static_cast<const T*>(X),              \
      static_cast<const T*>(z), static_cast<const T*>(w), mask, B, N, d,    \
      n_shape, fit_sigma, vec, c, out)
  switch (nc) {
    case 1: K5_LAUNCH(1); break;
    case 2: K5_LAUNCH(2); break;
    case 3: K5_LAUNCH(3); break;
    case 4: K5_LAUNCH(4); break;
    default: return cudaErrorInvalidValue;
  }
#undef K5_LAUNCH
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int k, int nc, const void* points, const void* X,
                     const void* z, const void* w, const uint8_t* mask,
                     int64_t B, int64_t N, int d, int n_shape, int fit_sigma,
                     int vec, const double* consts, double* out, int threads,
                     cudaStream_t s) {
  Consts<T> c;
  c.first = T(consts[0]);
  c.root_half_pi = T(consts[1]);
  c.sqrt_v = T(consts[2]);
  c.threshold = T(consts[3]);
  c.log_sqrt_2pi = consts[4];
  for (int j = 0; j < kMaxCoeffs; ++j) c.coeffs[j] = j < nc ? T(consts[5 + j]) : T(0);
  switch (k) {
    case 1: return launch_nc<T, 1>(nc, points, X, z, w, mask, B, N, d, n_shape, fit_sigma, vec, c, out, threads, s);
    case 2: return launch_nc<T, 2>(nc, points, X, z, w, mask, B, N, d, n_shape, fit_sigma, vec, c, out, threads, s);
    case 3: return launch_nc<T, 3>(nc, points, X, z, w, mask, B, N, d, n_shape, fit_sigma, vec, c, out, threads, s);
    case 4: return launch_nc<T, 4>(nc, points, X, z, w, mask, B, N, d, n_shape, fit_sigma, vec, c, out, threads, s);
    case 5: return launch_nc<T, 5>(nc, points, X, z, w, mask, B, N, d, n_shape, fit_sigma, vec, c, out, threads, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point for ctypes. dtype: 0 = float32, 1 = float64. consts:
// first, sqrt(pi / 2), sqrt(nu), the clip, log sqrt(2 pi), then the nc
// Horner coefficients. vec: 1 when N is a multiple of the 16-byte vector's
// length and every row is 16-byte aligned. Returns the cudaError_t of the
// launch (0 on success); the caller raises otherwise.
extern "C" int fisher_z_nll_launch(int dtype, int k, int nc, const void* points,
                                   const void* X, const void* z, const void* w,
                                   const void* mask, int64_t B, int64_t N,
                                   int d, int n_shape, int fit_sigma, int vec,
                                   const double* consts, void* out,
                                   int threads, void* stream) {
  if (B <= 0 || N <= 0 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || k > kMaxPoints || d < n_shape + fit_sigma) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  double* o = static_cast<double*>(out);
  if (dtype == 0) {
    return dispatch<float>(k, nc, points, X, z, w, m, B, N, d, n_shape,
                           fit_sigma, vec, consts, o, threads, s);
  }
  if (dtype == 1) {
    return dispatch<double>(k, nc, points, X, z, w, m, B, N, d, n_shape,
                            fit_sigma, vec, consts, o, threads, s);
  }
  return cudaErrorInvalidValue;
}

// The kernel's limits, so the wrapper checks against the source's own.
extern "C" int fisher_z_nll_max_points() { return kMaxPoints; }
extern "C" int fisher_z_nll_max_coeffs() { return kMaxCoeffs; }
