// The batched Nelder-Mead trip's bookkeeping on the card, for Hopper
// (sm_90a): kernels P (prepare) and D (decide) of ops/cuda/simplex.py.
//
// Replaces no Pallas kernel of glomargridding_tpu: there the simplex is a
// lax.while_loop that XLA compiles once (ops/optim.py). In the port, the
// eager loop (ops/optim.batched_nelder_mead) spends a trip of the 1-degree
// fit on ~60 PyTorch launches and one host read: ~1.5 ms of host against
// ~0.26 ms of device work, so the card idled 88-93% of the fit. Here a trip
// is four launches with no host decision in it,
//
//   P -> K5 (the 4 candidates, masked to the active lanes)
//     -> D -> K5 (the shrunk simplex, masked to the shrinking lanes),
//
// which ops/cuda/simplex.py captures as a CUDA graph of many trips.
//
// What bounds them: nothing on the card. One thread a lane reads and
// writes a few hundred bytes (the simplex, its values, the candidates);
// at 2,048 lanes a launch is a few microseconds, all of it launch latency.
//
// P, one thread a lane:
//  * completes the previous trip's selection as D recorded it (`pick`:
//    0 the lane was frozen, 1-4 the reflection, expansion, outside or
//    inside contraction replaces the worst vertex, 5 the shrunk simplex
//    replaces the simplex) and counts the lane's iteration;
//  * tests convergence (f_spread <= fatol and x_spread <= xatol about the
//    stably-first best vertex) and nit < maxiter: the `active` mask;
//  * for an active lane, sorts the d + 1 vertices stably by value (once a
//    trip: the eager loop sorts twice), and writes the centroid's four
//    clipped candidates and the clipped shrunk simplex, which needs no
//    objective value.
// D, one thread a lane: scipy's decision tree on the candidates' values
// (ops/optim._decide), the lane's `pick` and the `shrinking` mask.
//
// Bit for bit the eager loop's. The simplex compares float64 values that
// differ in their last bits, so every floating-point operation is written
// rounded (__fadd_rn and kin: nvcc contracts nothing into an FMA) in the
// order the eager loop's PyTorch kernels take it on the card:
//  * the sort is a stable sort on the keys of PyTorch's radix sort
//    (radixSortKVInPlace: NaN last, -0.0 before +0.0);
//  * the centroid is torch.mean's reduction over the d best vertices: a
//    sum from 0 in vertex order, times the factor (B d) / (B d d) that
//    the reduction computes in the working type (the wrapper passes it);
//  * a clip is torch.clamp's: NaN stays NaN, else min(max(v, lo), hi);
//  * the spreads' maxima propagate NaN as torch.amax does, and xatol is
//    compared in the working type, as a Python float meets a tensor.
//
// The tallies (int64, read by the host once a replay):
//   [0], [1]  the active lanes of the trips of even and odd index in the
//             captured chain (D of a trip zeroes the next trip's slot);
//   [2]       the trips run;
//   [3]       the eager loop's trips: the index (from 1) of the first trip
//             that found no lane active, 0 until then;
//   [4], [5]  the trips in which some lane shrank, and the last of them;
//   [6], [7]  the shrinking lanes and the active lanes, summed over trips;
//   [8]       K5's launches (K5 counts itself there, ops/cuda/ellipse_nll);
//   [9]       D's launches ([2] counts P's).
//
// Templates: T in {float, double}; D, the parameters, 2..4 (K5's forms).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 128;
constexpr int kCandidates = 4;
constexpr uint8_t kShrink = 5;
enum Tally {
  kActiveEven = 0, kActiveOdd = 1, kTrips = 2, kIterations = 3,
  kShrinkTrips = 4, kLastShrink = 5, kShrunkLanes = 6, kActiveLanes = 7,
  kK5Launches = 8, kDecides = 9, kTallies = 10
};

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }
__device__ __forceinline__ float min_t(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_t(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float max_t(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_t(double a, double b) { return fmax(a, b); }

// torch.clamp(v, min=lo, max=hi) on the card
template <typename T>
__device__ __forceinline__ T clip(T v, T lo, T hi) {
  return isnan(v) ? v : min_t(max_t(v, lo), hi);
}

// torch.amax's step: NaN propagates
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (isnan(a) || a > b) ? a : b;
}

// the key PyTorch's radix sort orders a float64 by
__device__ __forceinline__ u64 sort_key(double v) {
  const u64 x = static_cast<u64>(__double_as_longlong(v));
  const u64 mask = (x >> 63) ? ~0ull : 0x8000000000000000ull;
  return (v == v) ? (x ^ mask) : ~0ull;
}

template <typename T>
struct Trip {
  T* x;               // (B, d + 1, d) the simplex
  double* f;          // (B, d + 1) its values
  int32_t* nit;       // (B,)
  T* xs;              // (B, d + 1, d) the trip's sorted simplex
  double* fs;         // (B, d + 1) its values
  T* cand;            // (4, B, d) reflection, expansion, outside, inside
  const double* fc;   // (4, B) their values (K5)
  T* shrunk;          // (d + 1, B, d) the shrunk simplex
  const double* fsh;  // (d + 1, B) its values (K5)
  uint8_t* active;    // (B,)
  const uint8_t* pick;  // (B,) D's record of the previous trip
  const T* lo;        // (d,)
  const T* hi;        // (d,)
  u64* tally;         // (kTallies,)
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
nm_prepare_kernel(Trip<T> t, int64_t B, T xatol, double fatol, int maxiter,
                  T factor, int slot) {
  constexpr int V = D + 1;
  const int64_t b = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b == 0) t.tally[kTrips] += 1;
  bool act = false;
  if (b < B) {
    T* x = t.x + b * V * D;
    double* f = t.f + b * V;
    const uint8_t p = t.pick[b];
    if (p == kShrink) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        f[k] = t.fsh[k * B + b];
#pragma unroll
        for (int j = 0; j < D; ++j) x[k * D + j] = t.shrunk[(k * B + b) * D + j];
      }
    } else if (p != 0) {
      const T* xs = t.xs + b * V * D;
      const double* fs = t.fs + b * V;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        f[k] = fs[k];
#pragma unroll
        for (int j = 0; j < D; ++j) x[k * D + j] = xs[k * D + j];
      }
      f[D] = t.fc[(p - 1) * B + b];
#pragma unroll
      for (int j = 0; j < D; ++j) x[D * D + j] = t.cand[((p - 1) * B + b) * D + j];
    }
    int32_t nit = t.nit[b];
    if (p != 0) t.nit[b] = ++nit;

    // the vertices, sorted stably by value: insertion by adjacent
    // exchanges, each only where the earlier key is strictly larger
    double fv[V];
    u64 key[V];
    T xv[V][D];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      fv[k] = f[k];
      key[k] = sort_key(fv[k]);
#pragma unroll
      for (int j = 0; j < D; ++j) xv[k][j] = x[k * D + j];
    }
#pragma unroll
    for (int i = 1; i < V; ++i) {
#pragma unroll
      for (int k = i; k > 0; --k) {
        if (key[k - 1] > key[k]) {
          const u64 tk = key[k - 1]; key[k - 1] = key[k]; key[k] = tk;
          const double tf = fv[k - 1]; fv[k - 1] = fv[k]; fv[k] = tf;
#pragma unroll
          for (int j = 0; j < D; ++j) {
            const T tx = xv[k - 1][j]; xv[k - 1][j] = xv[k][j]; xv[k][j] = tx;
          }
        }
      }
    }

    double f_spread = abs_t(sub_rn(fv[1], fv[0]));
#pragma unroll
    for (int k = 2; k < V; ++k) f_spread = max_nan(f_spread, abs_t(sub_rn(fv[k], fv[0])));
    T x_spread = abs_t(sub_rn(xv[1][0], xv[0][0]));
#pragma unroll
    for (int k = 1; k < V; ++k) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        x_spread = max_nan(x_spread, abs_t(sub_rn(xv[k][j], xv[0][j])));
      }
    }
    act = !(f_spread <= fatol && x_spread <= xatol) && nit < maxiter;
    t.active[b] = act;

    if (act) {
      T* xs = t.xs + b * V * D;
      double* fs = t.fs + b * V;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        fs[k] = fv[k];
#pragma unroll
        for (int j = 0; j < D; ++j) xs[k * D + j] = xv[k][j];
      }
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const T lo = t.lo[j], hi = t.hi[j];
        T c = T(0);
#pragma unroll
        for (int k = 0; k < D; ++k) c = add_rn(c, xv[k][j]);
        c = mul_rn(c, factor);
        const T dir = sub_rn(c, xv[D][j]);
        const T half = mul_rn(dir, T(0.5));
        t.cand[(0 * B + b) * D + j] = clip(add_rn(c, dir), lo, hi);
        t.cand[(1 * B + b) * D + j] = clip(add_rn(c, mul_rn(dir, T(2))), lo, hi);
        t.cand[(2 * B + b) * D + j] = clip(add_rn(c, half), lo, hi);
        t.cand[(3 * B + b) * D + j] = clip(sub_rn(c, half), lo, hi);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const T s = add_rn(xv[0][j], mul_rn(sub_rn(xv[k][j], xv[0][j]), T(0.5)));
          t.shrunk[(k * B + b) * D + j] = clip(s, lo, hi);
        }
      }
    }
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, act);
  if (threadIdx.x % 32 == 0 && ballot) {
    const u64 n = static_cast<u64>(__popc(ballot));
    atomicAdd(&t.tally[slot], n);
    atomicAdd(&t.tally[kActiveLanes], n);
  }
}

__global__ void __launch_bounds__(kThreads)
nm_decide_kernel(const double* __restrict__ fc, const double* __restrict__ fs,
                 const uint8_t* __restrict__ active, uint8_t* __restrict__ pick,
                 uint8_t* __restrict__ shrinking, u64* tally, int64_t B, int d,
                 int slot) {
  const int64_t b = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b == 0) {
    if (tally[slot] == 0 && tally[kIterations] == 0) {
      tally[kIterations] = tally[kTrips];
    }
    tally[slot ^ 1] = 0;
    tally[kDecides] += 1;
  }
  bool shrink = false;
  if (b < B) {
    uint8_t p = 0;
    if (active[b]) {
      const double fr = fc[b], fe = fc[B + b], foc = fc[2 * B + b],
                   fic = fc[3 * B + b];
      const double* f = fs + b * (d + 1);
      const double fb = f[0], fsw = f[d - 1], fw = f[d];
      // ops/optim._decide
      const bool take_expand = (fr < fb) && (fe < fr);
      const bool take_reflect = ((fr < fb) && !(fe < fr)) || ((fr >= fb) && (fr < fsw));
      const bool outside = (fr >= fsw) && (fr < fw);
      const bool take_oc = outside && (foc <= fr);
      const bool inside = fr >= fw;
      shrink = (outside && !(foc <= fr)) || (inside && !(fic < fw));
      p = shrink ? kShrink : take_expand ? 2 : take_reflect ? 1 : take_oc ? 3 : 4;
    }
    pick[b] = p;
    shrinking[b] = shrink;
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, shrink);
  if (threadIdx.x % 32 == 0 && ballot) {
    atomicAdd(&tally[kShrunkLanes], static_cast<u64>(__popc(ballot)));
    const u64 trip = tally[kTrips];
    if (atomicMax(&tally[kLastShrink], trip) < trip) {
      atomicAdd(&tally[kShrinkTrips], 1ull);
    }
  }
}

template <typename T>
cudaError_t prepare(int d, const Trip<T>& t, int64_t B, double xatol,
                    double fatol, int maxiter, double factor, int slot,
                    cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((B + kThreads - 1) / kThreads));
  switch (d) {
    case 2: nm_prepare_kernel<T, 2><<<grid, kThreads, 0, s>>>(t, B, T(xatol), fatol, maxiter, T(factor), slot); break;
    case 3: nm_prepare_kernel<T, 3><<<grid, kThreads, 0, s>>>(t, B, T(xatol), fatol, maxiter, T(factor), slot); break;
    case 4: nm_prepare_kernel<T, 4><<<grid, kThreads, 0, s>>>(t, B, T(xatol), fatol, maxiter, T(factor), slot); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
Trip<T> trip_of(void* const* p) {
  Trip<T> t;
  t.x = static_cast<T*>(p[0]);
  t.f = static_cast<double*>(p[1]);
  t.nit = static_cast<int32_t*>(p[2]);
  t.xs = static_cast<T*>(p[3]);
  t.fs = static_cast<double*>(p[4]);
  t.cand = static_cast<T*>(p[5]);
  t.fc = static_cast<const double*>(p[6]);
  t.shrunk = static_cast<T*>(p[7]);
  t.fsh = static_cast<const double*>(p[8]);
  t.active = static_cast<uint8_t*>(p[9]);
  t.pick = static_cast<const uint8_t*>(p[10]);
  t.lo = static_cast<const T*>(p[11]);
  t.hi = static_cast<const T*>(p[12]);
  t.tally = static_cast<u64*>(p[13]);
  return t;
}

}  // namespace

// C entry points for ctypes; each returns the launch's cudaError_t (0 on
// success). dtype: 0 = float32, 1 = float64. ptrs: the 14 buffers in the
// order of struct Trip. xatol and factor are rounded to the dtype here.
extern "C" int nm_prepare_launch(int dtype, int d, int64_t B, void* const* ptrs,
                                 double xatol, double fatol, int maxiter,
                                 double factor, int slot, void* stream) {
  if (B <= 0 || (slot != 0 && slot != 1)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return prepare<float>(d, trip_of<float>(ptrs), B, xatol, fatol, maxiter, factor, slot, s);
  }
  if (dtype == 1) {
    return prepare<double>(d, trip_of<double>(ptrs), B, xatol, fatol, maxiter, factor, slot, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" int nm_decide_launch(int d, int64_t B, const void* fc, const void* fs,
                                const void* active, void* pick, void* shrinking,
                                void* tally, int slot, void* stream) {
  if (B <= 0 || d < 2 || d > 4 || (slot != 0 && slot != 1)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(static_cast<unsigned>((B + kThreads - 1) / kThreads));
  nm_decide_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(fc), static_cast<const double*>(fs),
      static_cast<const uint8_t*>(active), static_cast<uint8_t*>(pick),
      static_cast<uint8_t*>(shrinking), static_cast<u64*>(tally), B, d, slot);
  return cudaGetLastError();
}

// The tallies' count, so the wrapper checks against the source's own.
extern "C" int nm_tallies() { return kTallies; }
