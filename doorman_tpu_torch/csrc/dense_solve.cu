// Dense lane-solve kernels for Hopper (sm_90a): K1 (the lane solve) and
// K2 (the lane solve fused with the delivered-grant delta epilogue).
//
// Replaces the TPU Pallas kernels doorman_tpu/solver/pallas_dense.py
// `_kernel` (K1, reached through solve_dense_pallas) and `_fused_kernel`
// (K2, reached through fused_tick_pallas). Plain PyTorch versions:
// doorman_tpu_torch/solver/dense.py `solve_dense` (K1) and
// `fused_tick_plain` (K2); the wrappers live in solver/dense_cuda.py.
//
// What it computes, per resource row r of a [R, K] table: the lane
// solve of solver/lanes.py `solve_lanes` — inactive lanes masked to 0,
// then the lane of the row's algo_kind (NO_ALGORITHM, STATIC,
// PROPORTIONAL_SHARE, PROPORTIONAL_TOPUP, FAIR_SHARE bisection + snap,
// MAX_MIN_FAIR / PROPORTIONAL_FAIRNESS fills, BALANCED_FAIRNESS peel),
// or the LEARN replay of `has` on learning rows. Every reduction is
// within a row.
//
// What bounds it: the bytes — each row's wants/has/subclients/active are
// read from device memory once and its grants written once (K2 adds prev
// read + prev_new write + one flag per row), while the iterative lanes
// (up to 48 bisection passes, 16 fill passes, 8 peel rounds) re-read the
// row from shared memory, never from device memory.
//
// Design: one thread block per row. The row is staged in shared memory
// (dynamic; 4*K*sizeof(T) + 2*K bytes, up to 136 KB at f64 and
// K = 4096, above the 48 KB default only after the opt-in); thread t
// owns lanes t, t + blockDim, ..., so every elementwise step touches
// only the thread's own lanes. Reductions are a fixed-order tree —
// per-thread left-to-right partials, an xor-butterfly across the warp,
// then the warp partials summed in warp order by every thread — with no
// atomics, so the same inputs give bit-identical grants on every launch
// (the scoped tick's fixpoint test depends on it). The algorithm kind
// is per row, so the block takes only its own lane: the where-chain of
// the reference selects exactly that lane, so skipping the others is
// byte-identical. Built with -fmad=false and without fast math: each
// elementwise expression rounds as the plain version's does (the one
// multiply-add the reference fuses is an explicit fma), and only the
// order of a sum differs. min/max are written out to propagate NaN
// as torch.minimum/maximum do (fminf/fmaxf would drop it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kFillIters = 16;      // algorithms/tick.py FILL_ITERS
constexpr int kBalancedRounds = 8;  // algorithms/tick.py BALANCED_ROUNDS
constexpr int kRefineIters = 2;     // solver/lanes.py _REFINE_ITERS
constexpr int kRedSlots = 64;       // two sums of up to 32 warps

// algorithms/kinds.py AlgoKind
enum : int {
  kNoAlgorithm = 0,
  kStatic = 1,
  kProportionalShare = 2,
  kFairShare = 3,
  kProportionalTopup = 4,
  kMaxMinFair = 7,
  kBalancedFairness = 8,
  kProportionalFairness = 9,
};

template <typename T>
struct Num;
template <>
struct Num<float> {
  __device__ static float tiny() { return FLT_MIN; }
  static constexpr int kBisect = 30;
};
template <>
struct Num<double> {
  __device__ static double tiny() { return DBL_MIN; }
  static constexpr int kBisect = 48;
};

template <typename T>
__device__ __forceinline__ T nmax(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
template <typename T>
__device__ __forceinline__ T nmin(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  // Butterfly: lane i and lane i^o add the same two values (addition is
  // commutative), so every lane ends with the identical sum.
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
  for (int o = 16; o > 0; o >>= 1) v = nmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
__device__ T block_sum(T v, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T s = red[0];
  for (int w = 1; w < nw; ++w) s += red[w];
  __syncthreads();
  return s;
}

template <typename T>
__device__ void block_sum2(T& a, T& b, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  T sa = red[0], sb = red[32];
  for (int w = 1; w < nw; ++w) {
    sa += red[w];
    sb += red[32 + w];
  }
  __syncthreads();
  a = sa;
  b = sb;
}

template <typename T>
__device__ T block_max(T v, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T m = red[0];
  for (int w = 1; w < nw; ++w) m = nmax(m, red[w]);
  __syncthreads();
  return m;
}

// Sum over the row of f(j), in the fixed order described above.
template <typename T, typename F>
__device__ __forceinline__ T row_sum(int K, F f, T* red) {
  T acc = T(0);
  for (int j = threadIdx.x; j < K; j += blockDim.x) acc += f(j);
  return block_sum(acc, red);
}

// The shared row state of one block.
template <typename T>
struct Row {
  int K;
  T* w;        // wants, masked
  T* h;        // has, masked
  T* s;        // subclients, masked
  T* g;        // grants (output)
  uint8_t* a;  // active
  uint8_t* fixed;
  T* red;
};

// Fill iteration (solver/lanes.py iterfill_level) with weights
// s (PROPORTIONAL_FAIRNESS) or the active mask (MAX_MIN_FAIR).
template <typename T>
__device__ T iterfill_level(const Row<T>& r, T cap, bool unit_weights) {
  const T zero = T(0), tiny = Num<T>::tiny();
  auto wt = [&](int j) -> T {
    return unit_weights ? (r.a[j] ? T(1) : zero) : r.s[j];
  };
  T level = cap / nmax(row_sum<T>(r.K, wt, r.red), tiny);
  for (int it = 0; it < kFillIters; ++it) {
    T sat_w = zero, unsat_w = zero;
    for (int j = threadIdx.x; j < r.K; j += blockDim.x) {
      const bool sat = r.w[j] <= level * wt(j);
      sat_w += sat ? r.w[j] : zero;
      unsat_w += sat ? zero : wt(j);
    }
    block_sum2(sat_w, unsat_w, r.red);
    const T level_new = (cap - sat_w) / nmax(unsat_w, tiny);
    level = unsat_w > zero ? nmax(level, level_new) : level;
  }
  return level;
}

// Weighted max-min water level of an overloaded row (solver/lanes.py
// waterfill_level with underloaded = false): bisection, then the
// closed-form snap.
template <typename T>
__device__ T waterfill_level(const Row<T>& r, T cap) {
  const T zero = T(0), tiny = Num<T>::tiny();
  T mr = -INFINITY;
  for (int j = threadIdx.x; j < r.K; j += blockDim.x) {
    const T ratio = r.s[j] > zero ? r.w[j] / nmax(r.s[j], tiny) : zero;
    mr = nmax(mr, r.a[j] ? ratio : T(-INFINITY));
  }
  T max_ratio = block_max(mr, r.red);
  if (!isfinite(max_ratio)) max_ratio = zero;
  T lo = zero, hi = nmax(max_ratio, zero);
  for (int it = 0; it < Num<T>::kBisect; ++it) {
    const T mid = (lo + hi) * T(0.5);
    const T granted = row_sum<T>(
        r.K, [&](int j) { return nmin(r.w[j], mid * r.s[j]); }, r.red);
    if (granted < cap) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  T level = hi;
  for (int it = 0; it < kRefineIters; ++it) {
    T sat_w = zero, unsat = zero;
    for (int j = threadIdx.x; j < r.K; j += blockDim.x) {
      const bool sat = r.w[j] <= level * r.s[j];
      sat_w += sat ? r.w[j] : zero;
      unsat += sat ? zero : r.s[j];
    }
    block_sum2(sat_w, unsat, r.red);
    const T exact = unsat > zero ? (cap - sat_w) / nmax(unsat, tiny) : level;
    level = nmax(exact, zero);
  }
  return level;
}

// Balanced-fairness grants of an overloaded row (solver/lanes.py
// balanced_fill), written into r.g.
template <typename T>
__device__ void balanced_fill(const Row<T>& r, T cap) {
  const T zero = T(0), one = T(1), tiny = Num<T>::tiny();
  for (int j = threadIdx.x; j < r.K; j += blockDim.x) r.fixed[j] = 0;
  auto livef = [&](int j) -> T {
    return r.fixed[j] ? zero : (r.a[j] ? one : zero);
  };
  auto ratio = [&](int j) -> T {
    return (livef(j) > zero && r.w[j] > zero) ? r.s[j] / nmax(r.w[j], tiny)
                                              : zero;
  };
  T remcap = cap;
  T cap_ratio, max_ratio;
  for (int round = 0; round <= kBalancedRounds; ++round) {
    T X = zero, mr = -INFINITY;
    for (int j = threadIdx.x; j < r.K; j += blockDim.x) {
      X += livef(j) * r.s[j];
      mr = nmax(mr, ratio(j));
    }
    X = block_sum(X, r.red);
    max_ratio = nmax(block_max(mr, r.red), zero);
    cap_ratio = X / nmax(remcap, tiny);
    if (round == kBalancedRounds) break;
    // Peel against the ratios of the fixed set BEFORE this round: each
    // thread reads and writes only its own lanes.
    const bool binding = max_ratio > cap_ratio;
    T peeled = zero;
    for (int j = threadIdx.x; j < r.K; j += blockDim.x) {
      const bool peel = ratio(j) >= max_ratio && binding;
      peeled += peel ? r.w[j] : zero;
      if (peel) r.fixed[j] = 1;
    }
    remcap = remcap - block_sum(peeled, r.red);
  }
  const T theta = nmax(cap_ratio, max_ratio);
  const T nu = one / nmax(theta, tiny);
  for (int j = threadIdx.x; j < r.K; j += blockDim.x)
    r.g[j] = r.fixed[j] ? r.w[j] : nmin(r.w[j], r.s[j] * nu);
}

// The row's grants into r.g (inactive lanes 0).
template <typename T>
__device__ void solve_row(const Row<T>& r, T cap, int kind, bool learn,
                          T statc) {
  const T zero = T(0), tiny = Num<T>::tiny();
  const int K = r.K;
  if (learn) {
    // LEARN replays the (masked) reported grant whatever the lane.
    for (int j = threadIdx.x; j < K; j += blockDim.x) r.g[j] = r.h[j];
    return;
  }
  const T sumw = row_sum<T>(K, [&](int j) { return r.w[j]; }, r.red);
  const bool fits = sumw <= cap;
  switch (kind) {
    case kNoAlgorithm:
      for (int j = threadIdx.x; j < K; j += blockDim.x) r.g[j] = r.w[j];
      break;
    case kStatic:
      for (int j = threadIdx.x; j < K; j += blockDim.x)
        r.g[j] = nmin(statc, r.w[j]);
      break;
    case kProportionalShare: {
      const T sum_has = row_sum<T>(K, [&](int j) { return r.h[j]; }, r.red);
      const bool under = sumw < cap;
      const T scale = cap / nmax(sumw, tiny);
      for (int j = threadIdx.x; j < K; j += blockDim.x) {
        const T free_c = nmax(cap - (sum_has - r.h[j]), zero);
        r.g[j] = under ? nmin(r.w[j], free_c) : nmin(r.w[j] * scale, free_c);
      }
      break;
    }
    case kProportionalTopup: {
      T sum_has = zero, count = zero;
      for (int j = threadIdx.x; j < K; j += blockDim.x) {
        sum_has += r.h[j];
        count += r.s[j];
      }
      block_sum2(sum_has, count, r.red);
      const T eq = cap / nmax(count, tiny);
      T extra_cap = zero, extra_need = zero;
      for (int j = threadIdx.x; j < K; j += blockDim.x) {
        const T equal = eq * r.s[j];
        const bool under = r.w[j] < equal;
        extra_cap += under ? equal - r.w[j] : zero;
        extra_need += under ? zero : r.w[j] - equal;
      }
      block_sum2(extra_cap, extra_need, r.red);
      const T top = extra_cap / nmax(extra_need, tiny);
      for (int j = threadIdx.x; j < K; j += blockDim.x) {
        const T equal = eq * r.s[j];
        const T free_c = nmax(cap - (sum_has - r.h[j]), zero);
        // The one fused multiply-add of the lane solve: XLA contracts
        // this expression, and the plain version writes it as addcmul.
        const T topped = fma(r.w[j] - equal, top, equal);
        r.g[j] = (fits || r.w[j] <= equal) ? nmin(r.w[j], free_c)
                                           : nmin(topped, free_c);
      }
      break;
    }
    case kFairShare: {
      if (fits) {
        for (int j = threadIdx.x; j < K; j += blockDim.x) r.g[j] = r.w[j];
        break;
      }
      const T level = waterfill_level(r, cap);
      for (int j = threadIdx.x; j < K; j += blockDim.x)
        r.g[j] = nmin(r.w[j], level * r.s[j]);
      break;
    }
    case kMaxMinFair:
    case kProportionalFairness: {
      if (fits) {
        for (int j = threadIdx.x; j < K; j += blockDim.x) r.g[j] = r.w[j];
        break;
      }
      const bool unit = kind == kMaxMinFair;
      const T level = iterfill_level(r, cap, unit);
      for (int j = threadIdx.x; j < K; j += blockDim.x) {
        const T wt = unit ? (r.a[j] ? T(1) : zero) : r.s[j];
        r.g[j] = nmin(r.w[j], level * wt);
      }
      break;
    }
    case kBalancedFairness:
      if (fits) {
        for (int j = threadIdx.x; j < K; j += blockDim.x) r.g[j] = r.w[j];
      } else {
        balanced_fill(r, cap);
      }
      break;
    default:
      // A kind without a lane here (PRIORITY_BANDS) solves to 0, as the
      // reference's where-chain leaves it.
      for (int j = threadIdx.x; j < K; j += blockDim.x) r.g[j] = zero;
  }
  for (int j = threadIdx.x; j < K; j += blockDim.x)
    if (!r.a[j]) r.g[j] = zero;
}

template <typename P, typename T>
struct Cast {
  __device__ static P to(T x) { return static_cast<P>(x); }
  __device__ static bool differ(P a, P b) { return a != b; }
};
template <typename T>
struct Cast<__nv_bfloat16, T> {
  // torch rounds double -> bfloat16 through float: keep its rounding.
  __device__ static __nv_bfloat16 to(T x) {
    return __float2bfloat16_rn(static_cast<float>(x));
  }
  __device__ static bool differ(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __bfloat162float(a) != __bfloat162float(b);
  }
};

struct Inputs {
  const void* wants;
  const void* has;
  const void* sub;
  const uint8_t* act;
  const void* cap;
  const int32_t* kind;
  const uint8_t* learn;
  const void* statc;
};

// K1 (kFused = false): grants of rows `rows[b]` (or b when rows is
// null) into out[b]. K2 (kFused = true): over the whole table, grants
// into out, the delivered-row epilogue into prev_out / changed.
template <typename T, typename P, bool kFused>
__global__ void __launch_bounds__(kMaxThreads)
    dense_solve_kernel(Inputs in, const int32_t* __restrict__ rows,
                       T* __restrict__ out, const P* prev,
                       const uint8_t* __restrict__ delivered, P* prev_out,
                       uint8_t* __restrict__ changed, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int64_t src = rows != nullptr ? rows[b] : b;
  Row<T> r;
  r.K = K;
  r.w = reinterpret_cast<T*>(smem);
  r.h = r.w + K;
  r.s = r.h + K;
  r.g = r.s + K;
  r.red = r.g + K;
  r.a = reinterpret_cast<uint8_t*>(r.red + kRedSlots);
  r.fixed = r.a + K;

  const T* wants = static_cast<const T*>(in.wants) + src * K;
  const T* has = static_cast<const T*>(in.has) + src * K;
  const T* sub = static_cast<const T*>(in.sub) + src * K;
  const uint8_t* act = in.act + src * K;
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    const uint8_t a = act[j] != 0;
    r.a[j] = a;
    r.w[j] = a ? wants[j] : T(0);
    r.h[j] = a ? has[j] : T(0);
    r.s[j] = a ? sub[j] : T(0);
  }
  __syncthreads();
  const T cap = static_cast<const T*>(in.cap)[src];
  const T statc = static_cast<const T*>(in.statc)[src];
  solve_row(r, cap, in.kind[src], in.learn[src] != 0, statc);

  T* out_row = out + static_cast<int64_t>(b) * K;
  if constexpr (!kFused) {
    for (int j = threadIdx.x; j < K; j += blockDim.x) out_row[j] = r.g[j];
  } else {
    const P* prev_row = prev + src * K;
    P* prev_new = prev_out + static_cast<int64_t>(b) * K;
    const bool deliv = delivered[src] != 0;
    int diff = 0;
    for (int j = threadIdx.x; j < K; j += blockDim.x) {
      const T g = r.g[j];
      const P c = Cast<P, T>::to(g);
      const P p = prev_row[j];
      diff |= Cast<P, T>::differ(c, p);
      out_row[j] = g;
      prev_new[j] = deliv ? c : p;
    }
    const int any = __syncthreads_or(diff);
    if (threadIdx.x == 0) changed[b] = (deliv && any) ? 1 : 0;
  }
}

int threads_for(int K) {
  int t = ((K + 31) / 32) * 32;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

template <typename T>
size_t smem_for(int K) {
  return 4 * static_cast<size_t>(K) * sizeof(T) + kRedSlots * sizeof(T) +
         2 * static_cast<size_t>(K);
}

template <typename T, typename P, bool kFused>
int launch(Inputs in, const void* rows, void* out, const void* prev,
           const void* delivered, void* prev_out, void* changed, int n_rows,
           int K, void* stream) {
  if (n_rows <= 0 || K <= 0) return 0;
  auto kernel = dense_solve_kernel<T, P, kFused>;
  const size_t smem = smem_for<T>(K);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<n_rows, threads_for(K), smem, static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const int32_t*>(rows), static_cast<T*>(out),
      static_cast<const P*>(prev), static_cast<const uint8_t*>(delivered),
      static_cast<P*>(prev_out), static_cast<uint8_t*>(changed), K);
  return static_cast<int>(cudaGetLastError());
}

Inputs make_inputs(const void* wants, const void* has, const void* sub,
                   const void* act, const void* cap, const void* kind,
                   const void* learn, const void* statc) {
  Inputs in;
  in.wants = wants;
  in.has = has;
  in.sub = sub;
  in.act = static_cast<const uint8_t*>(act);
  in.cap = cap;
  in.kind = static_cast<const int32_t*>(kind);
  in.learn = static_cast<const uint8_t*>(learn);
  in.statc = statc;
  return in;
}

}  // namespace

// The C interface bound with ctypes. Every pointer is a device pointer
// (tensor.data_ptr()), `stream` is the caller's cudaStream_t; the return
// value is cudaGetLastError() after the launch (0 = launched).
#define DSK_K1(NAME, T)                                                     \
  extern "C" int NAME(const void* wants, const void* has, const void* sub, \
                      const void* act, const void* cap, const void* kind,  \
                      const void* learn, const void* statc,                \
                      const void* rows, void* out, int n_rows, int K,      \
                      void* stream) {                                       \
    return launch<T, T, false>(                                             \
        make_inputs(wants, has, sub, act, cap, kind, learn, statc), rows,   \
        out, nullptr, nullptr, nullptr, nullptr, n_rows, K, stream);        \
  }

#define DSK_K2(NAME, T, P)                                                  \
  extern "C" int NAME(const void* wants, const void* has, const void* sub, \
                      const void* act, const void* cap, const void* kind,  \
                      const void* learn, const void* statc,                \
                      const void* prev, const void* delivered, void* gets, \
                      void* prev_out, void* changed, int n_rows, int K,    \
                      void* stream) {                                       \
    return launch<T, P, true>(                                              \
        make_inputs(wants, has, sub, act, cap, kind, learn, statc),         \
        nullptr, gets, prev, delivered, prev_out, changed, n_rows, K,       \
        stream);                                                            \
  }

DSK_K1(dsk_k1_f32, float)
DSK_K1(dsk_k1_f64, double)
DSK_K2(dsk_k2_f32_f32, float, float)
DSK_K2(dsk_k2_f32_bf16, float, __nv_bfloat16)
DSK_K2(dsk_k2_f64_f64, double, double)
DSK_K2(dsk_k2_f64_bf16, double, __nv_bfloat16)
