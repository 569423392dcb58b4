// Free-gas scattering-law density on Hopper (sm_90a): for every outgoing
// Gauss-Legendre node y of every row, the u-integral of the free-gas
// S(alpha, beta) density and its Legendre moments, in native float64.
//
// Replaces the XLA-level JAX function ndpp_tpu/ops/freegas.py::_sab_dens
// (lines 580-645) as the port's freegas_moments_sab runs it: the torch op
// chain of ops/freegas.py (_sab_dens and the chunk loop of
// _outgoing_panelsplit), which materialises (T, chunk x NQ_G, 20, 24)
// float64 tensors a chunk at a time and takes ~390 launches per call. Here
// nothing of size (T, NY, 20, 24) reaches device memory: one launch covers
// every (row, y-node), and each thread keeps its L+1 sums in registers.
//
// For one row (v = sqrt(E), A, kT) and one outgoing point y:
//   beta_s = (y^2 - v^2) / kT, c = |beta_s|,
//   u in [u_lo, u_hi] from the exact endpoint identities (clipped at 8.5),
//   20 u-panels cut at lo, hi, the fixed ladder ULAD and the ladder
//   sqrt(c) CLAD (both clipped into [lo, hi]), 24 GL nodes each;
//   at a node: t = u + sqrt(u^2 + c), weight w jac exp(-u^2 - max(beta_s, 0))
//   with jac = t / sqrt(u^2 + c), mu = clip(m0 - m1 t^2, -1, 1), and
//   P_0..P_L(mu) by Bonnet's recursion; the sums times 2y are the output.
//
// What bounds it: operations. At the thermal deck's shape (256 rows, 39
// y-panels x 20 nodes, P5) each call is ~9.6e7 (y, u) nodes of one exp, one
// sqrt, one division and ~30 other float64 operations, while it reads 2
// (T, NP) panel tables and writes a (T, NP, 20, L+1) table (~10 MB).
// What the design does about it:
//   - one thread per (row, y-node): 480 nodes of work each, no
//     cross-thread reduction, no shared memory, no atomics; a block holds
//     kThreads nodes of one row (grid.x = row), so a row's scalars are read
//     once per block and stay in registers;
//   - the 21 sorted u-edges are a two-way merge in registers: lo is the
//     least and hi the greatest (u_hi >= u_lo, the ladders are clipped into
//     [lo, hi]), and both clipped ladders are ascending (clip is monotone,
//     sqrt(c) >= 0), so the torch.sort of the plain version becomes a walk
//     that takes the smaller head of the two ladders at each step: the
//     same multiset of edges, hence the same panels;
//   - a zero-width panel (ladder values clipped onto one another) adds 0 in
//     the plain version and is skipped here;
//   - the GL rules and both ladders are the kernel's __grid_constant__
//     parameter block (the constant bank): read by every thread, written
//     by none; L is a template parameter <= 10, so the L+1 sums and the
//     Bonnet constants A_l = (2l+1)/(l+1), B_l = l/(l+1) are registers and
//     immediates.
// The output y = pmid + phalf x_q is rounded as torch rounds it (a product,
// then a sum), so the kernel evaluates the density at the plain version's
// points; the sums differ from it by summation order and by the ulps of
// exp, sqrt and division.
//
// Launch contract (freegas_sab_launch): float arrays are float64,
// contiguous, on the current device. pmid/phalf are (T, NP); v/awr/kt are
// (T,); xg (nq_g), xu/wu (NQ_U = 24), ulad (11) and clad (8) are in HOST
// memory (copied into the launch's parameters); out is (T, NP, nq_g, L+1).
// The launch is asynchronous on `stream`; the return value is
// cudaGetLastError() right after it (0 = launched).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kNqU = 24;
constexpr int kMaxNqG = 64;
constexpr int kULad = 11;
constexpr int kCLad = 8;
constexpr double kUClip = 8.5;

struct Rules {
  double xg[kMaxNqG];
  double xu[kNqU];
  double wu[kNqU];
  double ulad[kULad];
  double clad[kCLad];
};

__device__ __forceinline__ double clip(double x, double lo, double hi) { return fmin(fmax(x, lo), hi); }

// P_2..P_L: p_{l+1} = A_l mu p_l - B_l p_{l-1}, acc_{l+1} += w p_{l+1}.
template <int L, int l>
__device__ __forceinline__ void bonnet(double x, double w, double p_prev, double p_cur,
                                       double (&acc)[L + 1]) {
  if constexpr (l < L) {
    constexpr double kA = (2.0 * l + 1.0) / (l + 1.0);
    constexpr double kB = static_cast<double>(l) / (l + 1.0);
    const double p_next = fma(kA * x, p_cur, -kB * p_prev);
    acc[l + 1] = fma(w, p_next, acc[l + 1]);
    bonnet<L, l + 1>(x, w, p_cur, p_next, acc);
  }
}

// The 24 GL nodes of the u-panel [e0, e1] into acc.
template <int L>
__device__ __forceinline__ void u_panel(double e0, double e1, double c, double bpos, double m0,
                                        double m1, const Rules& r, double (&acc)[L + 1]) {
  const double pm = 0.5 * (e1 + e0);
  const double ph = 0.5 * (e1 - e0);
#pragma unroll 4
  for (int q = 0; q < kNqU; ++q) {
    const double u = fma(ph, r.xu[q], pm);
    const double w = ph * r.wu[q];
    const double root = sqrt(fma(u, u, c));
    const double t = u + root;
    const double jac = t / fmax(root, 1e-30);
    const double base = w * jac * exp(-(u * u) - bpos);
    const double mu = clip(m0 - m1 * t * t, -1.0, 1.0);
    acc[0] += base;
    if constexpr (L >= 1) {
      acc[1] = fma(base, mu, acc[1]);
      bonnet<L, 1>(mu, base, 1.0, mu, acc);
    }
  }
}

template <int L>
__global__ void __launch_bounds__(kThreads)
    freegas_sab_kernel(const double* __restrict__ pmid, const double* __restrict__ phalf,
                       const double* __restrict__ v_rows, const double* __restrict__ awr_rows,
                       const double* __restrict__ kt_rows, int n_panels, int nq_g,
                       const __grid_constant__ Rules r, double* __restrict__ out) {
  const int t = blockIdx.x;
  const int i = blockIdx.y * kThreads + threadIdx.x;  // node of the row: panel i / nq_g, point i % nq_g
  if (i >= n_panels * nq_g) return;
  const double v = __ldg(v_rows + t);
  const double awr = __ldg(awr_rows + t);
  const double kt = __ldg(kt_rows + t);
  const double akt = awr * kt;
  const double sq_akt = sqrt(akt);
  const double sq_a_kt = sqrt(awr / kt);

  const long long p = static_cast<long long>(t) * n_panels + i / nq_g;
  const double y = __dadd_rn(__ldg(pmid + p), __dmul_rn(__ldg(phalf + p), r.xg[i % nq_g]));
  const double dy = fabs(y - v);
  const double sy = y + v;
  const double beta_s = (y * y - v * v) / kt;
  const double c = fabs(beta_s);
  const double lo = fmax(0.5 * (dy / sq_akt - sy * sq_a_kt), -kUClip);
  const double hi = fmax(fmin(0.5 * (sy / sq_akt - dy * sq_a_kt), kUClip), lo);
  const double denom = fmax(2.0 * v * y, 1e-30);
  const double m0 = (v * v + y * y) / denom;
  const double m1 = akt / denom;
  const double sc = sqrt(c);
  const double bpos = fmax(beta_s, 0.0);

  double acc[L + 1];
#pragma unroll
  for (int l = 0; l <= L; ++l) acc[l] = 0.0;
  // lo, the two clipped ladders merged, hi: 21 ascending edges, 20 panels
  double e0 = lo;
  int a = 0, b = 0;
  for (int k = 0; k < kULad + kCLad + 1; ++k) {
    double e1 = hi;
    if (a + b < kULad + kCLad) {
      const double ua = a < kULad ? clip(r.ulad[a], lo, hi) : CUDART_INF;
      const double cb = b < kCLad ? clip(sc * r.clad[b], lo, hi) : CUDART_INF;
      if (ua <= cb) {
        e1 = ua;
        ++a;
      } else {
        e1 = cb;
        ++b;
      }
    }
    if (e1 > e0) u_panel<L>(e0, e1, c, bpos, m0, m1, r, acc);
    e0 = e1;
  }
  const double dedy = 2.0 * y;  // g(y) = dF/dE' dE'/dy
  double* __restrict__ o = out + (static_cast<long long>(t) * n_panels * nq_g + i) * (L + 1);
#pragma unroll
  for (int l = 0; l <= L; ++l) o[l] = acc[l] * dedy;
}

template <int L>
void launch(const double* pmid, const double* phalf, const double* v, const double* awr,
            const double* kt, int t_rows, int n_panels, int nq_g, const Rules& r, double* out,
            cudaStream_t stream) {
  const dim3 grid(t_rows, (n_panels * nq_g + kThreads - 1) / kThreads);
  freegas_sab_kernel<L><<<grid, kThreads, 0, stream>>>(pmid, phalf, v, awr, kt, n_panels, nq_g, r, out);
}

}  // namespace

extern "C" int freegas_sab_launch(const double* pmid, const double* phalf, const double* v,
                                  const double* awr, const double* kt, int t_rows, int n_panels,
                                  int nq_g, int order, const double* xg, const double* xu,
                                  const double* wu, const double* ulad, const double* clad,
                                  double* out, void* stream_handle) {
  if (t_rows <= 0 || n_panels <= 0 || nq_g <= 0 || nq_g > kMaxNqG ||
      (n_panels * nq_g + kThreads - 1) / kThreads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Rules r{};
  for (int q = 0; q < nq_g; ++q) r.xg[q] = xg[q];
  for (int q = 0; q < kNqU; ++q) {
    r.xu[q] = xu[q];
    r.wu[q] = wu[q];
  }
  for (int k = 0; k < kULad; ++k) r.ulad[k] = ulad[k];
  for (int k = 0; k < kCLad; ++k) r.clad[k] = clad[k];
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  switch (order) {
    case 0: launch<0>(pmid, phalf, v, awr, kt, t_rows, n_panels, nq_g, r, out, stream); break;
    case 1: launch<1>(pmid, phalf, v, awr, kt, t_rows, n_panels, nq_g, r, out, stream); break;
    case 2: launch<2>(pmid, phalf, v, awr, kt, t_rows, n_panels, nq_g, r, out, stream); break;
    case 3: launch<3>(pmid, phalf, v, awr, kt, t_rows, n_panels, nq_g, r, out, stream); break;
    case 4: launch<4>(pmid, phalf, v, awr, kt, t_rows, n_panels, nq_g, r, out, stream); break;
    case 5: launch<5>(pmid, phalf, v, awr, kt, t_rows, n_panels, nq_g, r, out, stream); break;
    case 6: launch<6>(pmid, phalf, v, awr, kt, t_rows, n_panels, nq_g, r, out, stream); break;
    case 7: launch<7>(pmid, phalf, v, awr, kt, t_rows, n_panels, nq_g, r, out, stream); break;
    case 8: launch<8>(pmid, phalf, v, awr, kt, t_rows, n_panels, nq_g, r, out, stream); break;
    case 9: launch<9>(pmid, phalf, v, awr, kt, t_rows, n_panels, nq_g, r, out, stream); break;
    case 10: launch<10>(pmid, phalf, v, awr, kt, t_rows, n_panels, nq_g, r, out, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
