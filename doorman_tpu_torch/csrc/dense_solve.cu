// Dense solve kernels for Hopper (sm_90a): K1 (the lane solve), K2 (the
// lane solve fused with the delivered-grant delta epilogue) and K3 (the
// banded water-fill of the priority solve, further below). Each comes in
// two layouts: one warp per row for rows of up to kWarpMaxK = 256 lanes,
// one block per row above; K3 has a third, one block per row read from
// global memory, for rows wider than shared memory. The wrappers pick
// the layout from the width (solver/dense_cuda.py k1_layout for K1/K2,
// solver/priority_cuda.py k3_layout for K3).
//
// K1 and K2 replace the TPU Pallas kernels doorman_tpu/solver/
// pallas_dense.py:40 `_kernel` (reached through solve_dense_pallas) and
// :57 `_fused_kernel` (reached through fused_tick_pallas). Plain PyTorch
// versions: doorman_tpu_torch/solver/dense.py `solve_dense` (K1) and
// `fused_tick_plain` (K2).
//
// What K1 computes, per resource row r of a [R, K] table: the lane
// solve of solver/lanes.py `solve_lanes` — inactive lanes masked to 0,
// then the lane of the row's algo_kind (NO_ALGORITHM, STATIC,
// PROPORTIONAL_SHARE, PROPORTIONAL_TOPUP, FAIR_SHARE bisection + snap,
// MAX_MIN_FAIR / PROPORTIONAL_FAIRNESS fills, BALANCED_FAIRNESS peel),
// or the LEARN replay of `has` on learning rows. Every reduction is
// within a row. K2 adds, over the whole table, prev_new (prev advanced on
// delivered rows) and changed[r] = delivered[r] and any(cast(gets) !=
// prev) on the row.
//
// What bounds it on this card: not the bytes. The lane cell's 10,240 x
// 128 f32 table is 22 MB with its grants (0.0067 ms at 3.35 TB/s). The
// time goes to chains of dependent row reductions: an overflowing
// FAIR_SHARE row runs a max, 30 (f32) or 48 (f64) bisection sums and two
// paired snap sums; the fills 1 + 16 paired sums; BALANCED_FAIRNESS nine
// rounds of a sum and a max and eight peel sums. In the block-per-row
// layout each is a block reduction (a shuffle butterfly, a round trip
// through shared memory, two __syncthreads and a serial walk over the
// warp partials), on 128 threads that hold one element each.
//
// Warp layout (dense_solve_warp_kernel, K <= 256): one warp per row,
// kRowsPerBlock = 8 rows to a 256-thread block, grid = ceil(R / 8). Lane l
// holds elements j = l + 32 v, 0 <= v < V, V = ceil(K / 32) rounded up to
// 1, 2, 4 or 8 (a template parameter), so each v is one coalesced load
// for the warp. The row lives in registers and the masks (active, inside
// the row, the balanced peel's fixed set) in bitmasks. The algorithm kind
// is the row's, so the whole warp takes one branch, and each branch loads
// only the arrays its lane reads (the fair and fill lanes read the
// subclients only when the row overflows). Every reduction is the lane's
// left-to-right partial over v followed by warp_sum / warp_max's xor
// butterfly: five shuffles, no shared memory, no __syncthreads, no
// atomics, and every lane ends with the same bits, so every branch on a
// reduced value is uniform and repeat launches are bit-identical (the
// scoped tick's fixpoint test depends on it).
//
// Block layout (dense_solve_kernel, any K up to the table's width): one
// thread block per row, the row staged in dynamic shared memory
// (4*K*sizeof(T) + 2*K bytes, up to 136 KB at f64 and K = 4096, above the
// 48 KB default after the opt-in); thread t owns lanes t, t + blockDim,
// ..., and every reduction is a fixed-order tree — per-thread
// left-to-right partials, the xor butterfly, then the warp partials
// summed in warp order by every thread. A warp would need 128 values a
// lane for each array of a 4,096-lane row, far past the 255 registers a
// thread may have.
//
// Both layouts: the block or warp takes only its row's lane (the
// where-chain of the reference selects exactly that lane, so skipping
// the others is byte-identical). Built with -fmad=false and without fast
// math: each elementwise expression rounds as the plain version's does
// (the one multiply-add the reference fuses is an explicit fma), and only
// the order of a sum differs between the layouts and the plain version.
// min/max are written out to propagate NaN as torch.minimum/maximum do
// (fminf/fmaxf would drop it).

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
constexpr int kWarpMaxK = 256;      // the widest row of the warp layout
constexpr int kRowsPerBlock = 8;    // warp layout: rows (warps) a block
constexpr int kGlobalThreads = 1024;  // K3 global layout: threads a row

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

// ---- K1/K2 for narrow rows: one warp per row (the layout the header
// describes; dense_solve_kernel above keeps rows wider than kWarpMaxK).
//
// On an H100 80GB HBM3 at 700 W, chip_smoke.py timed K1 in this layout
// at 0.0166 ms and in the block layout at 0.0409 ms on the lane
// server's 10,240 x 128 f32 table (K2: 0.0195 and 0.0442 ms), against
// a bound of 0.0067 ms (K2: 0.0098 ms) for the bytes.
//
// Registers (ptxas -v for sm_90a, printed by chip_smoke.py's build
// phase; a spilling warp entry fails that phase): K1 28, 30, 40 and 64
// at f32 for V = 1, 2, 4, 8 and 42, 50, 70 and 112 at f64; K2 26, 30,
// 44, 65 and 44, 52, 68, 112, for either prev type; no spills. At 40
// (the main path's f32 V = 4) six blocks, 48 warps, fit on an SM, and
// 10,240 rows take about 1.6 waves.

__device__ __forceinline__ bool bit(uint32_t mask, int v) {
  return (mask >> v) & 1u;
}

// x[v] = p[lane + 32 v] where element v is active, else 0: an inactive
// element is not read.
template <typename T, int V>
__device__ __forceinline__ void warp_load(const T* __restrict__ p, int lane,
                                          uint32_t act, T (&x)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) x[v] = bit(act, v) ? p[lane + 32 * v] : T(0);
}

// waterfill_level on one warp's registers: w and s are the masked wants
// and weights (K1: the row's; K3: the band's); bit v of `members` says
// whether element v takes part (K1: active; K3: in the band), bit v of
// `inside` whether it lies within the row.
template <typename T, int V>
__device__ __forceinline__ T warp_waterfill_level(const T (&w)[V],
                                                  const T (&s)[V],
                                                  uint32_t members,
                                                  uint32_t inside, T cap) {
  const T zero = T(0), tiny = Num<T>::tiny();
  T mr = -INFINITY;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const T ratio = s[v] > zero ? w[v] / nmax(s[v], tiny) : zero;
    mr = nmax(mr, (members >> v) & 1u ? ratio : T(-INFINITY));
  }
  T max_ratio = warp_max(mr);
  if (!isfinite(max_ratio)) max_ratio = zero;
  T lo = zero, hi = nmax(max_ratio, zero);
  for (int it = 0; it < Num<T>::kBisect; ++it) {
    const T mid = (lo + hi) * T(0.5);
    T acc = zero;
#pragma unroll
    for (int v = 0; v < V; ++v)
      acc += (inside >> v) & 1u ? nmin(w[v], mid * s[v]) : zero;
    if (warp_sum(acc) < cap) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  T level = hi;
  for (int it = 0; it < kRefineIters; ++it) {
    T sat_w = zero, unsat = zero;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const bool sat = w[v] <= level * s[v];
      sat_w += sat ? w[v] : zero;
      unsat += sat ? zero : s[v];
    }
    sat_w = warp_sum(sat_w);
    unsat = warp_sum(unsat);
    const T exact = unsat > zero ? (cap - sat_w) / nmax(unsat, tiny) : level;
    level = nmax(exact, zero);
  }
  return level;
}

// iterfill_level on one warp's registers, with weights wt (the
// subclients, or the active mask for MAX_MIN_FAIR). Elements past K hold
// zeros and add +0 to both sums whatever the level.
template <typename T, int V>
__device__ __forceinline__ T warp_iterfill_level(const T (&w)[V],
                                                 const T (&wt)[V], T cap) {
  const T zero = T(0), tiny = Num<T>::tiny();
  T sum_wt = zero;
#pragma unroll
  for (int v = 0; v < V; ++v) sum_wt += wt[v];
  T level = cap / nmax(warp_sum(sum_wt), tiny);
  for (int it = 0; it < kFillIters; ++it) {
    T sat_w = zero, unsat_w = zero;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const bool sat = w[v] <= level * wt[v];
      sat_w += sat ? w[v] : zero;
      unsat_w += sat ? zero : wt[v];
    }
    sat_w = warp_sum(sat_w);
    unsat_w = warp_sum(unsat_w);
    const T level_new = (cap - sat_w) / nmax(unsat_w, tiny);
    level = unsat_w > zero ? nmax(level, level_new) : level;
  }
  return level;
}

// balanced_fill on one warp's registers, the grants into g. Bit v of
// `fixed` is the peeled set. An element past K is not active: it peels
// like an inactive element (adding its zero wants) and is never written.
template <typename T, int V>
__device__ __forceinline__ void warp_balanced_fill(const T (&w)[V],
                                                   const T (&s)[V],
                                                   uint32_t act, T cap,
                                                   T (&g)[V]) {
  const T zero = T(0), one = T(1), tiny = Num<T>::tiny();
  uint32_t fixed = 0;
  auto ratio = [&](int v) -> T {
    return (bit(act & ~fixed, v) && w[v] > zero) ? s[v] / nmax(w[v], tiny)
                                                 : zero;
  };
  T remcap = cap;
  T cap_ratio, max_ratio;
  for (int round = 0; round <= kBalancedRounds; ++round) {
    T X = zero, mr = -INFINITY;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const T livef = bit(act & ~fixed, v) ? one : zero;
      X += livef * s[v];
      mr = nmax(mr, ratio(v));
    }
    X = warp_sum(X);
    max_ratio = nmax(warp_max(mr), zero);
    cap_ratio = X / nmax(remcap, tiny);
    if (round == kBalancedRounds) break;
    // Peel against the ratios of the fixed set BEFORE this round.
    const bool binding = max_ratio > cap_ratio;
    T peeled = zero;
    uint32_t peel_bits = 0;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const bool peel = ratio(v) >= max_ratio && binding;
      peeled += peel ? w[v] : zero;
      peel_bits |= static_cast<uint32_t>(peel) << v;
    }
    fixed |= peel_bits;
    remcap = remcap - warp_sum(peeled);
  }
  const T theta = nmax(cap_ratio, max_ratio);
  const T nu = one / nmax(theta, tiny);
#pragma unroll
  for (int v = 0; v < V; ++v)
    g[v] = bit(fixed, v) ? w[v] : nmin(w[v], s[v] * nu);
}

// solve_row on one warp's registers: the row's grants into g (inactive
// elements, and elements past K, 0). Each branch reads only the arrays
// its lane uses, once; `off` is the row's offset in the [R, K] tables.
template <typename T, int V>
__device__ __forceinline__ void warp_solve_row(const Inputs& in, int64_t off,
                                               int lane, uint32_t act,
                                               uint32_t inside, T cap,
                                               int kind, bool learn, T statc,
                                               T (&g)[V]) {
  const T zero = T(0), tiny = Num<T>::tiny();
  const T* wants = static_cast<const T*>(in.wants) + off;
  const T* has = static_cast<const T*>(in.has) + off;
  const T* sub = static_cast<const T*>(in.sub) + off;
  if (learn) {
    // LEARN replays the (masked) reported grant whatever the lane.
    warp_load(has, lane, act, g);
    return;
  }
  T w[V];
  warp_load(wants, lane, act, w);
  auto row_total = [&](const T(&x)[V]) -> T {
    T acc = zero;
#pragma unroll
    for (int v = 0; v < V; ++v) acc += x[v];
    return warp_sum(acc);
  };
  switch (kind) {
    case kNoAlgorithm:
#pragma unroll
      for (int v = 0; v < V; ++v) g[v] = w[v];
      break;
    case kStatic:
#pragma unroll
      for (int v = 0; v < V; ++v) g[v] = nmin(statc, w[v]);
      break;
    case kProportionalShare: {
      T h[V];
      warp_load(has, lane, act, h);
      const T sumw = row_total(w);
      const T sum_has = row_total(h);
      const bool under = sumw < cap;
      const T scale = cap / nmax(sumw, tiny);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const T free_c = nmax(cap - (sum_has - h[v]), zero);
        g[v] = under ? nmin(w[v], free_c) : nmin(w[v] * scale, free_c);
      }
      break;
    }
    case kProportionalTopup: {
      T h[V], s[V];
      warp_load(has, lane, act, h);
      warp_load(sub, lane, act, s);
      const bool fits = row_total(w) <= cap;
      const T sum_has = row_total(h);
      const T eq = cap / nmax(row_total(s), tiny);
      // Elements past K are kept out: with a zero count eq is inf, and
      // eq * 0 is NaN.
      T extra_cap = zero, extra_need = zero;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const T equal = eq * s[v];
        const bool under = w[v] < equal;
        extra_cap += bit(inside, v) && under ? equal - w[v] : zero;
        extra_need += bit(inside, v) && !under ? w[v] - equal : zero;
      }
      const T top = warp_sum(extra_cap) / nmax(warp_sum(extra_need), tiny);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const T equal = eq * s[v];
        const T free_c = nmax(cap - (sum_has - h[v]), zero);
        // The one fused multiply-add of the lane solve (see solve_row).
        const T topped = fma(w[v] - equal, top, equal);
        g[v] = (fits || w[v] <= equal) ? nmin(w[v], free_c)
                                       : nmin(topped, free_c);
      }
      break;
    }
    case kFairShare:
    case kMaxMinFair:
    case kProportionalFairness:
    case kBalancedFairness: {
      if (row_total(w) <= cap) {
#pragma unroll
        for (int v = 0; v < V; ++v) g[v] = w[v];
        break;
      }
      // The row overflows: only now are its subclients read.
      T s[V];
      if (kind == kMaxMinFair) {
#pragma unroll
        for (int v = 0; v < V; ++v) s[v] = bit(act, v) ? T(1) : zero;
      } else {
        warp_load(sub, lane, act, s);
      }
      if (kind == kBalancedFairness) {
        warp_balanced_fill<T, V>(w, s, act, cap, g);
        break;
      }
      const T level = kind == kFairShare
                          ? warp_waterfill_level<T, V>(w, s, act, inside, cap)
                          : warp_iterfill_level<T, V>(w, s, cap);
#pragma unroll
      for (int v = 0; v < V; ++v) g[v] = nmin(w[v], level * s[v]);
      break;
    }
    default:
      // A kind without a lane here (PRIORITY_BANDS) solves to 0.
#pragma unroll
      for (int v = 0; v < V; ++v) g[v] = zero;
  }
#pragma unroll
  for (int v = 0; v < V; ++v) g[v] = bit(act, v) ? g[v] : zero;
}

// K1 (kFused = false) and K2 (kFused = true) as dense_solve_kernel, one
// warp per row: output row b is row rows[b] (or b when rows is null).
// The launch bounds ask for one block an SM at least, which leaves ptxas
// free to use up to 255 registers a thread: with the thread count alone
// it held the f64 V = 4 K1 entry to 64 and spilled.
template <typename T, typename P, bool kFused, int V>
__global__ void __launch_bounds__(kRowsPerBlock * 32, 1)
    dense_solve_warp_kernel(Inputs in, const int32_t* __restrict__ rows,
                            T* __restrict__ out, const P* prev,
                            const uint8_t* __restrict__ delivered,
                            P* prev_out, uint8_t* __restrict__ changed,
                            int n_rows, int K) {
  const int b = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  // The whole warp leaves together, so every shuffle below is full-warp.
  if (b >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const int64_t src = rows != nullptr ? rows[b] : b;
  const int64_t off = src * K;
  uint32_t act = 0, inside = 0;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int j = lane + 32 * v;
    const bool in_row = j < K;
    inside |= static_cast<uint32_t>(in_row) << v;
    act |= static_cast<uint32_t>(in_row && in.act[off + j] != 0) << v;
  }
  T g[V];
  warp_solve_row<T, V>(in, off, lane, act, inside,
                       static_cast<const T*>(in.cap)[src], in.kind[src],
                       in.learn[src] != 0,
                       static_cast<const T*>(in.statc)[src], g);
  T* out_row = out + static_cast<int64_t>(b) * K;
  if constexpr (!kFused) {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (bit(inside, v)) out_row[lane + 32 * v] = g[v];
  } else {
    const P* prev_row = prev + off;
    P* prev_new = prev_out + static_cast<int64_t>(b) * K;
    const bool deliv = delivered[src] != 0;
    bool diff = false;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (!bit(inside, v)) continue;
      const int j = lane + 32 * v;
      const P c = Cast<P, T>::to(g[v]);
      const P p = prev_row[j];
      diff |= Cast<P, T>::differ(c, p);
      out_row[j] = g[v];
      prev_new[j] = deliv ? c : p;
    }
    const bool any = __any_sync(0xffffffffu, diff);
    if (lane == 0) changed[b] = (deliv && any) ? 1 : 0;
  }
}

template <typename T, typename P, bool kFused>
int launch_warp(Inputs in, const void* rows, void* out, const void* prev,
                const void* delivered, void* prev_out, void* changed,
                int n_rows, int K, void* stream) {
  if (n_rows <= 0 || K <= 0) return 0;
  if (K > kWarpMaxK) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = K <= 32   ? dense_solve_warp_kernel<T, P, kFused, 1>
                : K <= 64  ? dense_solve_warp_kernel<T, P, kFused, 2>
                : K <= 128 ? dense_solve_warp_kernel<T, P, kFused, 4>
                           : dense_solve_warp_kernel<T, P, kFused, 8>;
  const int grid = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  kernel<<<grid, kRowsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const int32_t*>(rows), static_cast<T*>(out),
      static_cast<const P*>(prev), static_cast<const uint8_t*>(delivered),
      static_cast<P*>(prev_out), static_cast<uint8_t*>(changed), n_rows, K);
  return static_cast<int>(cudaGetLastError());
}

// ---- K3: the banded water-fill (solver/priority.py `_alloc_banded`).
//
// Replaces the TPU Pallas kernel doorman_tpu/solver/pallas_priority.py
// `_make_kernel(num_bands)` (reached through alloc_banded_pallas); the
// wrapper is solver/priority_cuda.py `alloc_banded_k3`, which launches
// this block-per-row layout for rows wider than kWarpMaxK lanes and
// banded_fill_warp_kernel (below) up to that width. Per row r, for
// rank 0..num_bands-1: mask m = active & band == rank; if the band's
// wants fit the remaining capacity every member gets its wants, else
// min(wants, level * weight) at the band's weighted max-min level
// (waterfill_level above); remaining = max(remaining - sum(share), 0).
//
// What bounds it: the bytes — wants, weights, band and active are read
// once and the grants written once; the band loop and each overflowing
// band's 30/48-step bisection re-read shared memory only. The group-cap
// bisection of solve_priority launches it 38 (f32) or 66 (f64) times a
// tick, one launch per theta evaluation.
//
// Design: K1's — one block per row, the row staged once in dynamic
// shared memory (5*K*sizeof(T) + 6*K bytes: wants and weights, the
// band-masked copies the level finder reads, the grants, the band ranks,
// the active and band masks; 185 KB at f64 and K = 4096, above 48 KB
// after the opt-in), fixed-order block reductions and no atomics, so
// repeat launches are bit-identical. The band loop runs to the run-time
// num_bands, and the level is computed only for a band that does not
// fit: the reference computes it for every band but selects it only
// there, so skipping it is byte-identical. With `totals` the block also
// writes its row's grant total, summed in the block's fixed order (the
// group usage of solve_priority).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    banded_fill_kernel(const T* __restrict__ wants,
                       const T* __restrict__ weights,
                       const int32_t* __restrict__ band,
                       const uint8_t* __restrict__ active,
                       const T* __restrict__ eff_cap, T* __restrict__ gets,
                       T* __restrict__ totals, int K, int num_bands) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t b = blockIdx.x;
  T* wa = reinterpret_cast<T*>(smem);  // wants, active-masked
  T* wt = wa + K;                      // weights, active-masked
  Row<T> r;
  r.K = K;
  r.w = wt + K;  // the band's wants
  r.s = r.w + K;  // the band's weights
  r.g = r.s + K;  // grants
  r.h = nullptr;
  r.red = r.g + K;
  int32_t* bnd = reinterpret_cast<int32_t*>(r.red + kRedSlots);
  uint8_t* act = reinterpret_cast<uint8_t*>(bnd + K);
  r.a = act + K;  // the band mask
  r.fixed = nullptr;

  const T zero = T(0);
  const int64_t off = b * K;
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    const uint8_t a = active[off + j] != 0;
    act[j] = a;
    wa[j] = a ? wants[off + j] : zero;
    wt[j] = a ? weights[off + j] : zero;
    bnd[j] = band[off + j];
    r.g[j] = zero;
  }
  T remaining = eff_cap[b];
  for (int rank = 0; rank < num_bands; ++rank) {
    T sumw = zero;
    for (int j = threadIdx.x; j < K; j += blockDim.x) {
      const uint8_t m = act[j] && bnd[j] == rank;
      r.a[j] = m;
      r.w[j] = m ? wa[j] : zero;
      r.s[j] = m ? wt[j] : zero;
      sumw += r.w[j];
    }
    // block_sum's barrier also publishes the masked copies.
    sumw = block_sum(sumw, r.red);
    const bool fits = sumw <= remaining;
    const T level = fits ? zero : waterfill_level(r, remaining);
    T taken = zero;
    for (int j = threadIdx.x; j < K; j += blockDim.x) {
      const T w = r.w[j];
      const T share =
          r.a[j] ? (fits ? w : nmin(w, level * r.s[j])) : zero;
      r.g[j] = r.g[j] + share;
      taken += share;
    }
    remaining = nmax(remaining - block_sum(taken, r.red), zero);
  }
  T* out = gets + off;
  T total = zero;
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    out[j] = r.g[j];
    total += r.g[j];
  }
  if (totals != nullptr) {
    total = block_sum(total, r.red);
    if (threadIdx.x == 0) totals[b] = total;
  }
}

template <typename T>
size_t k3_smem_for(int K) {
  return 5 * static_cast<size_t>(K) * sizeof(T) + kRedSlots * sizeof(T) +
         6 * static_cast<size_t>(K);
}

template <typename T>
int launch_k3(const void* wants, const void* weights, const void* band,
              const void* active, const void* eff_cap, void* gets,
              void* totals, int n_rows, int K, int num_bands, void* stream) {
  if (n_rows <= 0 || K <= 0) return 0;
  auto kernel = banded_fill_kernel<T>;
  const size_t smem = k3_smem_for<T>(K);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<n_rows, threads_for(K), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(wants), static_cast<const T*>(weights),
      static_cast<const int32_t*>(band), static_cast<const uint8_t*>(active),
      static_cast<const T*>(eff_cap), static_cast<T*>(gets),
      static_cast<T*>(totals), K, num_bands);
  return static_cast<int>(cudaGetLastError());
}

// ---- K3 for narrow rows: one warp per row.
//
// The same function as banded_fill_kernel (the TPU kernel it replaces is
// doorman_tpu/solver/pallas_priority.py:32 `_make_kernel`), for rows of
// up to kWarpMaxK = 256 lanes; priority_cuda.k3_layout picks the layout
// from K.
//
// What bounds it on this card: not the bytes. One launch over a
// 10,000 x 128 f32 table reads 22 MB once (0.0065 ms at 3.35 TB/s, and
// across the grouped solve's 38 launches the table stays in the 50 MB
// L2). The time goes to a chain of dependent reductions: each band that
// overflows runs a max, 30 (f32) or 48 (f64) bisection sums and two
// paired snap sums. In the block-per-row layout each is a block
// reduction with two __syncthreads and a round trip through shared
// memory — some 300 barriers a row with 4 bands, on 128 threads that
// hold one element each. Here each is V elementwise steps and five
// shuffles; what is left is issuing those instructions. On an H100
// 80GB HBM3 at 700 W, chip_smoke.py timed this layout at 0.0735 ms and
// the block layout at 0.2504 ms on the same 10,000 x 128 f32 tables.
//
// Design: one warp per row, kRowsPerBlock = 8 rows to a 256-thread
// block, grid = ceil(R / 8). Lane l holds elements j = l + 32 v,
// 0 <= v < V, V = ceil(K / 32) rounded up to 1, 2, 4 or 8 (a template
// parameter), so each v is one coalesced load for the warp. Registers
// only: the lane's band ranks (-1 for an inactive lane or one past K,
// so the band mask is one compare), its grants, and the current band's
// masked wants and weights, read from memory when the band comes up —
// each element belongs to one band, so each is still read once, and the
// row's wants and weights need no registers of their own (holding them
// too, ptxas spills at f64 V = 4). Every reduction — the band sum, the
// max ratio, each bisection sum, the two snaps' paired sums, the taken
// share, the row total — is the lane's left-to-right partial over v
// followed by warp_sum / warp_max's xor butterfly, which leaves the
// same value on every lane in a fixed order: no shared memory, no
// __syncthreads, no atomics, so repeat launches are bit-identical, and
// every branch on a reduced value is uniform across the warp. The level
// finder repeats waterfill_level's arithmetic step for step
// (NaN-propagating nmin/nmax, -fmad=false) and runs only for a band
// that overflows; against banded_fill_kernel only the order of the sums
// differs. Lanes past K hold zeros and are kept out of the bisection
// sums (whose min(w, mid * s) is NaN for a zero weight once mid
// overflows, as the plain version's is on a real lane).
//
// Wide rows keep banded_fill_kernel: a warp holding a row of 4,096 f64
// lanes would need 128 values a lane for each array, far past the 255
// registers a thread may have, while the block layout stages up to
// 227 KB of the row in shared memory.
//
// Registers (ptxas -v for sm_90a, printed by chip_smoke.py's build
// phase): 30, 30, 40 and 64 at f32 for V = 1, 2, 4, 8; 40, 48, 62 and
// 100 at f64; no spills. At 40 (the main path's f32 V = 4) six blocks,
// 48 warps, fit on an SM, and 10,000 rows take about 1.6 waves.
template <typename T, int V>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    banded_fill_warp_kernel(const T* __restrict__ wants,
                            const T* __restrict__ weights,
                            const int32_t* __restrict__ band,
                            const uint8_t* __restrict__ active,
                            const T* __restrict__ eff_cap,
                            T* __restrict__ gets, T* __restrict__ totals,
                            int n_rows, int K, int num_bands) {
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  // The whole warp leaves together, so every shuffle below is full-warp.
  if (b >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const T zero = T(0);
  const int64_t off = b * K;
  T g[V];
  int32_t bd[V];
  uint32_t inside = 0;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int j = lane + 32 * v;
    const bool a = j < K && active[off + j] != 0;
    inside |= static_cast<uint32_t>(j < K) << v;
    bd[v] = a ? band[off + j] : -1;
    g[v] = zero;
  }
  T remaining = eff_cap[b];
  for (int rank = 0; rank < num_bands; ++rank) {
    // The band's wants and weights are read when its rank comes up:
    // an element belongs to one band, so each is read once.
    T w[V], s[V];
    uint32_t members = 0;
    T sumw = zero;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const bool m = bd[v] == rank;
      members |= static_cast<uint32_t>(m) << v;
      w[v] = m ? wants[off + lane + 32 * v] : zero;
      s[v] = m ? weights[off + lane + 32 * v] : zero;
      sumw += w[v];
    }
    const bool fits = warp_sum(sumw) <= remaining;
    const T level = fits ? zero
                         : warp_waterfill_level<T, V>(w, s, members, inside,
                                                      remaining);
    T taken = zero;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const T share = (members >> v) & 1u
                          ? (fits ? w[v] : nmin(w[v], level * s[v]))
                          : zero;
      g[v] = g[v] + share;
      taken += share;
    }
    remaining = nmax(remaining - warp_sum(taken), zero);
  }
  T total = zero;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if ((inside >> v) & 1u) gets[off + lane + 32 * v] = g[v];
    total += g[v];
  }
  if (totals != nullptr) {
    total = warp_sum(total);
    if (lane == 0) totals[b] = total;
  }
}

template <typename T>
int launch_k3_warp(const void* wants, const void* weights, const void* band,
                   const void* active, const void* eff_cap, void* gets,
                   void* totals, int n_rows, int K, int num_bands,
                   void* stream) {
  if (n_rows <= 0 || K <= 0) return 0;
  if (K > kWarpMaxK) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = K <= 32   ? banded_fill_warp_kernel<T, 1>
                : K <= 64  ? banded_fill_warp_kernel<T, 2>
                : K <= 128 ? banded_fill_warp_kernel<T, 4>
                           : banded_fill_warp_kernel<T, 8>;
  const int grid = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  kernel<<<grid, kRowsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(wants), static_cast<const T*>(weights),
      static_cast<const int32_t*>(band), static_cast<const uint8_t*>(active),
      static_cast<const T*>(eff_cap), static_cast<T*>(gets),
      static_cast<T*>(totals), n_rows, K, num_bands);
  return static_cast<int>(cudaGetLastError());
}

// ---- K3 for rows wider than shared memory: one block per row, the row
// read from global memory in every pass ("global" layout).
//
// The same function as banded_fill_kernel (the TPU kernel it replaces is
// doorman_tpu/solver/pallas_priority.py:32 `_make_kernel`, reached
// through alloc_banded_pallas). priority_cuda.k3_layout picks it for a
// row whose block-layout staging (k3_smem_for) exceeds the 227 KB a
// block may use: K > 8,930 lanes at f32, > 5,042 at f64 — so every
// PRIORITY_BANDS resource the BatchSolver buckets to 16,384 clients or
// more at f32, 8,192 or more at f64.
//
// What bounds it: the bytes. Each pass over the row reads the active
// flags and band ranks (5 B an element) and, for the band's members,
// their wants and weights; the band loop, the max ratio, every
// bisection step and the two snaps are each such a pass, and the grants
// are read and written once a band. Counted once, a launch needs about
// 17 B an element at f32 (wants, weights, band, active read, grants
// written): about 5 us for a 1,048,576-lane row at 3.35 TB/s. A row of
// 8 x 131,072 f32 inputs is about 14 MB, so the passes after the first
// hit the 50 MB L2. One block per row leaves most of the 132 SMs idle
// when a few wide rows are all there is, and a block's passes run at
// one SM's share of the L2's bandwidth: this layout is right and
// simple, not fast. Spreading a row over a thread-block cluster, with
// the partials exchanged through distributed shared memory, is the
// redesign.
//
// Design: one block of up to kGlobalThreads threads per row; thread t
// owns elements t, t + T, t + 2T, ... (T = blockDim.x, coalesced) and
// accumulates its grants in the output in place, so no two threads
// touch one element and nothing else is staged. Every reduction has a
// fixed order: each thread sums its own elements left to right, then
// block_sum / block_max run the warp's xor butterfly and add the warp
// partials from shared memory in warp order, so every thread ends with
// the same bits; repeat launches are bit-identical, and there are no
// atomics, no grid-wide barrier and no cooperative launch. The strided
// loops are unrolled by 4, so a thread has several loads in flight (the
// order of its additions stays its elements' order). Non-members
// of a band enter each sum as the zeros the plain version's masked
// arrays hold (the bisection's min(0, mid * 0) included). The level is
// computed only for a band that does not fit, as in the other layouts.
template <typename T>
struct GlobalRow {
  const T* __restrict__ wants;
  const T* __restrict__ weights;
  const int32_t* __restrict__ band;
  const uint8_t* __restrict__ active;
  int K;
  int rank;
  // The band's masked wants and weights of element j; true for a member.
  __device__ __forceinline__ bool load(int j, T& w, T& s) const {
    const bool m = active[j] != 0 && band[j] == rank;
    w = m ? wants[j] : T(0);
    s = m ? weights[j] : T(0);
    return m;
  }
};

// waterfill_level above, over a band of a GlobalRow.
template <typename T>
__device__ T global_waterfill_level(const GlobalRow<T>& r, T cap, T* red) {
  const T zero = T(0), tiny = Num<T>::tiny();
  T mr = -INFINITY;
  #pragma unroll 4
  for (int j = threadIdx.x; j < r.K; j += blockDim.x) {
    T w, s;
    const bool m = r.load(j, w, s);
    const T ratio = s > zero ? w / nmax(s, tiny) : zero;
    mr = nmax(mr, m ? ratio : T(-INFINITY));
  }
  T max_ratio = block_max(mr, red);
  if (!isfinite(max_ratio)) max_ratio = zero;
  T lo = zero, hi = nmax(max_ratio, zero);
  for (int it = 0; it < Num<T>::kBisect; ++it) {
    const T mid = (lo + hi) * T(0.5);
    T acc = zero;
    #pragma unroll 4
    for (int j = threadIdx.x; j < r.K; j += blockDim.x) {
      T w, s;
      r.load(j, w, s);
      acc += nmin(w, mid * s);
    }
    if (block_sum(acc, red) < cap) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  T level = hi;
  for (int it = 0; it < kRefineIters; ++it) {
    T sat_w = zero, unsat = zero;
    #pragma unroll 4
    for (int j = threadIdx.x; j < r.K; j += blockDim.x) {
      T w, s;
      r.load(j, w, s);
      const bool sat = w <= level * s;
      sat_w += sat ? w : zero;
      unsat += sat ? zero : s;
    }
    block_sum2(sat_w, unsat, red);
    const T exact = unsat > zero ? (cap - sat_w) / nmax(unsat, tiny) : level;
    level = nmax(exact, zero);
  }
  return level;
}

// (kGlobalThreads, 1): one block an SM is all a row needs; without the
// 1, ptxas held the f64 entry at 32 registers and spilled.
template <typename T>
__global__ void __launch_bounds__(kGlobalThreads, 1)
    banded_fill_global_kernel(const T* __restrict__ wants,
                              const T* __restrict__ weights,
                              const int32_t* __restrict__ band,
                              const uint8_t* __restrict__ active,
                              const T* __restrict__ eff_cap,
                              T* __restrict__ gets, T* __restrict__ totals,
                              int K, int num_bands) {
  __shared__ T red[kRedSlots];
  const int64_t b = blockIdx.x;
  const int64_t off = b * K;
  const T zero = T(0);
  GlobalRow<T> r{wants + off, weights + off, band + off, active + off, K, 0};
  T* g = gets + off;
  for (int j = threadIdx.x; j < K; j += blockDim.x) g[j] = zero;
  T remaining = eff_cap[b];
  for (int rank = 0; rank < num_bands; ++rank) {
    r.rank = rank;
    T sumw = zero;
    #pragma unroll 4
    for (int j = threadIdx.x; j < K; j += blockDim.x) {
      T w, s;
      r.load(j, w, s);
      sumw += w;
    }
    const bool fits = block_sum(sumw, red) <= remaining;
    const T level = fits ? zero : global_waterfill_level(r, remaining, red);
    T taken = zero;
    #pragma unroll 4
    for (int j = threadIdx.x; j < K; j += blockDim.x) {
      T w, s;
      const bool m = r.load(j, w, s);
      const T share = m ? (fits ? w : nmin(w, level * s)) : zero;
      g[j] = g[j] + share;
      taken += share;
    }
    remaining = nmax(remaining - block_sum(taken, red), zero);
  }
  if (totals != nullptr) {
    T total = zero;
    for (int j = threadIdx.x; j < K; j += blockDim.x) total += g[j];
    total = block_sum(total, red);
    if (threadIdx.x == 0) totals[b] = total;
  }
}

template <typename T>
int launch_k3_global(const void* wants, const void* weights,
                     const void* band, const void* active,
                     const void* eff_cap, void* gets, void* totals,
                     int n_rows, int K, int num_bands, void* stream) {
  if (n_rows <= 0 || K <= 0) return 0;
  int threads = ((K + 31) / 32) * 32;
  if (threads > kGlobalThreads) threads = kGlobalThreads;
  banded_fill_global_kernel<T>
      <<<n_rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(wants), static_cast<const T*>(weights),
          static_cast<const int32_t*>(band),
          static_cast<const uint8_t*>(active),
          static_cast<const T*>(eff_cap), static_cast<T*>(gets),
          static_cast<T*>(totals), K, num_bands);
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
// value is cudaGetLastError() after the launch (0 = launched). LAUNCH is
// a layout's launcher: the block-per-row one (launch, launch_k3), the
// warp-per-row one (launch_warp, launch_k3_warp; K <= 256) or K3's
// global one (launch_k3_global, any K).
//
// K1: grants of rows `rows` (or of every row when rows is null) into
// out[n_rows, K].
#define DSK_K1(NAME, LAUNCH, T)                                             \
  extern "C" int NAME(const void* wants, const void* has, const void* sub, \
                      const void* act, const void* cap, const void* kind,  \
                      const void* learn, const void* statc,                \
                      const void* rows, void* out, int n_rows, int K,      \
                      void* stream) {                                       \
    return LAUNCH<T, T, false>(                                             \
        make_inputs(wants, has, sub, act, cap, kind, learn, statc), rows,   \
        out, nullptr, nullptr, nullptr, nullptr, n_rows, K, stream);        \
  }

// K2: over the whole table, grants into gets, the delivered-row epilogue
// into prev_out and changed.
#define DSK_K2(NAME, LAUNCH, T, P)                                          \
  extern "C" int NAME(const void* wants, const void* has, const void* sub, \
                      const void* act, const void* cap, const void* kind,  \
                      const void* learn, const void* statc,                \
                      const void* prev, const void* delivered, void* gets, \
                      void* prev_out, void* changed, int n_rows, int K,    \
                      void* stream) {                                       \
    return LAUNCH<T, P, true>(                                              \
        make_inputs(wants, has, sub, act, cap, kind, learn, statc),         \
        nullptr, gets, prev, delivered, prev_out, changed, n_rows, K,       \
        stream);                                                            \
  }

// K3: grants of every row of [n_rows, K] into gets, and (when totals is
// not null) each row's grant total into totals[n_rows].
#define DSK_K3(NAME, LAUNCH, T)                                              \
  extern "C" int NAME(const void* wants, const void* weights,               \
                      const void* band, const void* active,                 \
                      const void* eff_cap, void* gets, void* totals,        \
                      int n_rows, int K, int num_bands, void* stream) {     \
    return LAUNCH<T>(wants, weights, band, active, eff_cap, gets, totals,    \
                     n_rows, K, num_bands, stream);                          \
  }

DSK_K1(dsk_k1_block_f32, launch, float)
DSK_K1(dsk_k1_block_f64, launch, double)
DSK_K1(dsk_k1_warp_f32, launch_warp, float)
DSK_K1(dsk_k1_warp_f64, launch_warp, double)
DSK_K2(dsk_k2_block_f32_f32, launch, float, float)
DSK_K2(dsk_k2_block_f32_bf16, launch, float, __nv_bfloat16)
DSK_K2(dsk_k2_block_f64_f64, launch, double, double)
DSK_K2(dsk_k2_block_f64_bf16, launch, double, __nv_bfloat16)
DSK_K2(dsk_k2_warp_f32_f32, launch_warp, float, float)
DSK_K2(dsk_k2_warp_f32_bf16, launch_warp, float, __nv_bfloat16)
DSK_K2(dsk_k2_warp_f64_f64, launch_warp, double, double)
DSK_K2(dsk_k2_warp_f64_bf16, launch_warp, double, __nv_bfloat16)
DSK_K3(dsk_k3_block_f32, launch_k3, float)
DSK_K3(dsk_k3_block_f64, launch_k3, double)
DSK_K3(dsk_k3_warp_f32, launch_k3_warp, float)
DSK_K3(dsk_k3_warp_f64, launch_k3_warp, double)
DSK_K3(dsk_k3_global_f32, launch_k3_global, float)
DSK_K3(dsk_k3_global_f64, launch_k3_global, double)
