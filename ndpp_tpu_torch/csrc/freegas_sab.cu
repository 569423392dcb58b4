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
// every (row, y-node), and the lanes of a y-node keep its L+1 sums in
// registers.
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
// What bounds it: float64 instructions. At the thermal deck's shape (256
// rows, 39 y-panels x 20 nodes, P5) a call is 736,049 live u-panels x 24
// nodes, ~1.8e7 nodes, against 2 (T, NP) panel tables read and a (T, NP, 20,
// L+1) table written (~10 MB). Hopper has no float64 divide, square root or
// exp unit: each is a sequence of 8-25 instructions on the FP64 pipe, so
// they, not the Bonnet chain, were most of a node. What the design does:
//   - one rsqrt replaces the square root and the division: with d = u^2 + c
//     and r ~ 1/sqrt(d) (rsqrt.approx and one third-order correction, no
//     slow path), t = u + d r and jac = 1 + u r. The plain version floors
//     sqrt(d) at 1e-30 (jac = 0 at d = 0); below d = 1e-60 the node takes
//     that form, a branch no real node takes except at u = c = 0;
//   - a table for the fixed ladder: a u-panel whose two edges are
//     consecutive unclipped ULAD values has the same nodes, weights and
//     exp(-u^2) for every y of every row. The launch's (3, 10, 24) table
//     (ops/freegas.sab_ulad_table: u and w as the plain version rounds them)
//     is staged in shared memory (rows padded against bank conflicts), and
//     such a node's exponential is a table value times exp(-max(beta_s, 0)),
//     taken once per y-node. 54% of the live u-panels of the 256-row tile
//     are table panels, but a warp takes the table only at a step where
//     every live lane stands on one (a vote): a lane-by-lane choice split
//     warps between the two node loops and was slower than no table at all.
//     Other panels keep one exp per node (63 FP64-pipe instructions a node
//     against the table's 43, cuobjdump -sass);
//   - lane groups: G lanes (a template parameter, 1, 2, 4 or 8, dispatched
//     at launch from `lanes` as L is) own one y-node. They walk the same
//     edges; lane j takes nodes j, j + G, ... of each live panel, and the
//     group's L+1 sums meet in a fixed __shfl_xor_sync butterfly, so the
//     order of each sum depends only on G and two launches give the same
//     bits. The wrapper picks the smallest G that puts ~132 x 32 warps in
//     flight (ops/lanes.lane_group): 1 on the 256-row tile, 8 on the decks'
//     7-row tiles, where one lane per y-node left the card nearly idle;
//   - the 21 sorted u-edges are a two-way merge in registers: lo is the
//     least and hi the greatest, and both clipped ladders are ascending, so
//     the torch.sort of the plain version becomes a walk that takes the
//     smaller head of the two ladders at each step (the same multiset of
//     edges, hence the same panels); zero-width panels are skipped;
//   - the GL rules and both ladders are the kernel's __grid_constant__
//     parameter block (the constant bank); L is a template parameter <= 10,
//     so the L+1 sums and the Bonnet constants are registers and immediates;
//     the node loops are unrolled 4 times, and __launch_bounds__ leaves room
//     for 6 blocks per SM (<= 80 registers): without a bound ptxas spilled
//     some instances at its own 64-register target.
// Divergence costs little here: 85% of the lanes of a warp are live in each
// panel step on the 256-row tile, so a work list would buy at most 1.2x.
// Tensor cores do not apply (no matrix product: each node's P_l(mu)
// differs), nor does TMA (the inputs are two (T, NP) tables, read once).
// The output y = pmid + phalf x_q is rounded as torch rounds it (a product,
// then a sum), so the kernel evaluates the density at the plain version's
// points; the sums differ from it by summation order and by the ulps of
// exp and rsqrt.
//
// Launch contract (freegas_sab_launch): float arrays are float64,
// contiguous, on the current device. pmid/phalf are (T, NP); v/awr/kt are
// (T,); table is the (3, 10, 24) fixed-ladder table on the device; xg
// (nq_g), xu/wu (NQ_U = 24), ulad (11) and clad (8) are in HOST memory
// (copied into the launch's parameters); lanes is G (1, 2, 4 or 8);
// out is (T, NP, nq_g, L+1). The launch is asynchronous on `stream`; the
// return value is cudaGetLastError() right after it (0 = launched).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kNqU = 24;
constexpr int kMaxNqG = 64;
constexpr int kULad = 11;
constexpr int kCLad = 8;
constexpr int kTable = 3 * (kULad - 1) * kNqU;  // u, w, exp(-u^2) of the fixed-ladder panels
constexpr int kTabRow = kNqU + 1;                // a panel's row in shared memory, padded
constexpr int kTabPlane = (kULad - 1) * kTabRow;
constexpr int kMinBlocks = 6;  // blocks per SM the registers must leave room for (<= 80 registers)
constexpr double kUClip = 8.5;

struct Rules {
  double xg[kMaxNqG];
  double xu[kNqU];
  double wu[kNqU];
  double ulad[kULad];
  double clad[kCLad];
};

__device__ __forceinline__ double clip(double x, double lo, double hi) { return fmin(fmax(x, lo), hi); }

// 1/sqrt(x) for a normal x > 0, within an ulp or two: rsqrt.approx and one
// third-order correction, no slow path.
__device__ __forceinline__ double rsqrt_normal(double x) {
  double r;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
  const double e = fma(-x, r * r, 1.0);
  return fma(fma(0.375, e, 0.5), r * e, r);
}

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

// One u-node: weight we (the GL weight times the exponential) times the
// Jacobian, and the Legendre moments of mu, into acc.
template <int L>
__device__ __forceinline__ void u_node(double u, double we, double c, double m0, double m1,
                                       double (&acc)[L + 1]) {
  const double d = fma(u, u, c);
  const double r = rsqrt_normal(d);
  double t = fma(d, r, u);      // u + sqrt(d)
  double jac = fma(u, r, 1.0);  // t / sqrt(d)
  if (d < 1e-60) {              // the plain version's floor: t / max(sqrt(d), 1e-30)
    t = u + sqrt(d);
    jac = t * 1e30;
  }
  const double base = we * jac;
  const double mu = clip(fma(-(m1 * t), t, m0), -1.0, 1.0);
  acc[0] += base;
  if constexpr (L >= 1) {
    acc[1] = fma(base, mu, acc[1]);
    bonnet<L, 1>(mu, base, 1.0, mu, acc);
  }
}

// This lane's GL nodes of the u-panel [e0, e1] into acc: nodes sub, sub + G, ...
template <int L, int G>
__device__ __forceinline__ void u_panel(double e0, double e1, double c, double bpos, double m0, double m1,
                                        int sub, const Rules& r, double (&acc)[L + 1]) {
  const double pm = 0.5 * (e1 + e0);
  const double ph = 0.5 * (e1 - e0);
#pragma unroll 4
  for (int j = 0; j < kNqU / G; ++j) {  // node loop
    const int q = sub + j * G;
    const double u = fma(ph, r.xu[q], pm);
    u_node<L>(u, ph * r.wu[q] * exp(fma(-u, u, -bpos)), c, m0, m1, acc);
  }
}

// This lane's GL nodes of the fixed-ladder panel [ULAD[k], ULAD[k+1]],
// their u, weight and exp(-u^2) from the staged table.
template <int L, int G>
__device__ __forceinline__ void u_panel_table(const double* tab, int k, double c, double ebpos, double m0,
                                              double m1, int sub, double (&acc)[L + 1]) {
  const double* row = tab + k * kTabRow;
#pragma unroll 4
  for (int j = 0; j < kNqU / G; ++j) {  // node loop
    const int q = sub + j * G;
    u_node<L>(row[q], row[kTabPlane + q] * (row[2 * kTabPlane + q] * ebpos), c, m0, m1, acc);
  }
}

template <int L, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    freegas_sab_kernel(const double* __restrict__ pmid, const double* __restrict__ phalf,
                       const double* __restrict__ v_rows, const double* __restrict__ awr_rows,
                       const double* __restrict__ kt_rows, const double* __restrict__ table, int n_panels,
                       int nq_g, const __grid_constant__ Rules r, double* __restrict__ out) {
  __shared__ double tab[3 * kTabPlane];
  for (int j = threadIdx.x; j < kTable; j += kThreads) {  // rows padded to kTabRow against bank conflicts
    const int k = j / kNqU;
    tab[k * kTabRow + j % kNqU] = __ldg(table + j);
  }
  __syncthreads();
  const int t = blockIdx.x;
  // node of the row: panel i / nq_g, point i % nq_g; G lanes per node. Every
  // lane of the warp stays to the end (the warp votes on each panel step);
  // a lane past the row's nodes walks an empty range and stores nothing.
  const int n_nodes = n_panels * nq_g;
  const int i_raw = (blockIdx.y * kThreads + threadIdx.x) / G;
  const bool in_row = i_raw < n_nodes;
  const int i = in_row ? i_raw : n_nodes - 1;
  const int sub = threadIdx.x % G;
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
  const double hi = in_row ? fmax(fmin(0.5 * (sy / sq_akt - dy * sq_a_kt), kUClip), lo) : lo;
  const double denom = fmax(2.0 * v * y, 1e-30);
  const double m0 = (v * v + y * y) / denom;
  const double m1 = akt / denom;
  const double sc = sqrt(c);
  const double bpos = fmax(beta_s, 0.0);
  const double ebpos = exp(-bpos);

  double acc[L + 1];
#pragma unroll
  for (int l = 0; l <= L; ++l) acc[l] = 0.0;
  // lo, the two clipped ladders merged, hi: 21 ascending edges, 20 panels;
  // k0, k1: the ULAD index of e0, e1 when it is that ladder's value unclipped
  double e0 = lo;
  int a = 0, b = 0, k0 = -1;
  for (int k = 0; k < kULad + kCLad + 1; ++k) {
    double e1 = hi;
    int k1 = -1;
    if (a + b < kULad + kCLad) {
      const double ua = a < kULad ? clip(r.ulad[a], lo, hi) : CUDART_INF;
      const double cb = b < kCLad ? clip(sc * r.clad[b], lo, hi) : CUDART_INF;
      if (ua <= cb) {
        e1 = ua;
        if (ua == r.ulad[a]) k1 = a;
        ++a;
      } else {
        e1 = cb;
        ++b;
      }
    }
    // the table serves a step only when it serves every live lane of the
    // warp: the two node loops never split a warp
    const bool live = e1 > e0;
    const bool table_panel = k0 >= 0 && k1 == k0 + 1;
    const bool warp_table = __all_sync(0xffffffffu, table_panel || !live);
    if (live) {
      if (warp_table) {
        u_panel_table<L, G>(tab, k0, c, ebpos, m0, m1, sub, acc);
      } else {
        u_panel<L, G>(e0, e1, c, bpos, m0, m1, sub, r, acc);
      }
    }
    e0 = e1;
    k0 = k1;
  }
  if constexpr (G > 1) {  // the group's sums meet: the same bits in every lane
    const unsigned mask = ((1u << G) - 1) << (threadIdx.x & 31 & ~(G - 1));
#pragma unroll
    for (int m = 1; m < G; m <<= 1) {
#pragma unroll
      for (int l = 0; l <= L; ++l) acc[l] += __shfl_xor_sync(mask, acc[l], m);
    }
  }
  if (!in_row) return;
  const double dedy = 2.0 * y;  // g(y) = dF/dE' dE'/dy
  double* __restrict__ o = out + (static_cast<long long>(t) * n_nodes + i) * (L + 1);
#pragma unroll
  for (int l = 0; l <= L; ++l) {  // lane j writes l = j, j + G, ...
    if (l % G == sub) o[l] = acc[l] * dedy;
  }
}

template <int L, int G>
void launch_lanes(const double* pmid, const double* phalf, const double* v, const double* awr, const double* kt,
                  const double* table, int t_rows, int n_panels, int nq_g, const Rules& r, double* out,
                  cudaStream_t stream) {
  const dim3 grid(t_rows, (n_panels * nq_g * G + kThreads - 1) / kThreads);
  freegas_sab_kernel<L, G><<<grid, kThreads, 0, stream>>>(pmid, phalf, v, awr, kt, table, n_panels, nq_g, r, out);
}

template <int L>
void launch(const double* pmid, const double* phalf, const double* v, const double* awr, const double* kt,
            const double* table, int t_rows, int n_panels, int nq_g, int lanes, const Rules& r, double* out,
            cudaStream_t stream) {
  switch (lanes) {
    case 1: launch_lanes<L, 1>(pmid, phalf, v, awr, kt, table, t_rows, n_panels, nq_g, r, out, stream); break;
    case 2: launch_lanes<L, 2>(pmid, phalf, v, awr, kt, table, t_rows, n_panels, nq_g, r, out, stream); break;
    case 4: launch_lanes<L, 4>(pmid, phalf, v, awr, kt, table, t_rows, n_panels, nq_g, r, out, stream); break;
    default: launch_lanes<L, 8>(pmid, phalf, v, awr, kt, table, t_rows, n_panels, nq_g, r, out, stream); break;
  }
}

}  // namespace

extern "C" int freegas_sab_launch(const double* pmid, const double* phalf, const double* v,
                                  const double* awr, const double* kt, const double* table, int t_rows,
                                  int n_panels, int nq_g, int order, int lanes, const double* xg,
                                  const double* xu, const double* wu, const double* ulad, const double* clad,
                                  double* out, void* stream_handle) {
  if (t_rows <= 0 || n_panels <= 0 || nq_g <= 0 || nq_g > kMaxNqG ||
      (lanes != 1 && lanes != 2 && lanes != 4 && lanes != 8) ||
      (static_cast<long long>(n_panels) * nq_g * lanes + kThreads - 1) / kThreads > 65535) {
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
    case 0: launch<0>(pmid, phalf, v, awr, kt, table, t_rows, n_panels, nq_g, lanes, r, out, stream); break;
    case 1: launch<1>(pmid, phalf, v, awr, kt, table, t_rows, n_panels, nq_g, lanes, r, out, stream); break;
    case 2: launch<2>(pmid, phalf, v, awr, kt, table, t_rows, n_panels, nq_g, lanes, r, out, stream); break;
    case 3: launch<3>(pmid, phalf, v, awr, kt, table, t_rows, n_panels, nq_g, lanes, r, out, stream); break;
    case 4: launch<4>(pmid, phalf, v, awr, kt, table, t_rows, n_panels, nq_g, lanes, r, out, stream); break;
    case 5: launch<5>(pmid, phalf, v, awr, kt, table, t_rows, n_panels, nq_g, lanes, r, out, stream); break;
    case 6: launch<6>(pmid, phalf, v, awr, kt, table, t_rows, n_panels, nq_g, lanes, r, out, stream); break;
    case 7: launch<7>(pmid, phalf, v, awr, kt, table, t_rows, n_panels, nq_g, lanes, r, out, stream); break;
    case 8: launch<8>(pmid, phalf, v, awr, kt, table, t_rows, n_panels, nq_g, lanes, r, out, stream); break;
    case 9: launch<9>(pmid, phalf, v, awr, kt, table, t_rows, n_panels, nq_g, lanes, r, out, stream); break;
    case 10: launch<10>(pmid, phalf, v, awr, kt, table, t_rows, n_panels, nq_g, lanes, r, out, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
