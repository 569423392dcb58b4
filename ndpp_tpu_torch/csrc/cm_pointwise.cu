// The inner integral of the CM-frame continuum moments on Hopper (sm_90a):
// at every outer node w = sqrt(E'_lab) of every row, the y = sqrt(E'_cm)
// integral of p_E(y^2) p_mu(mu_cm) P_l(mu_lab) over [|w - s|, w + s], in
// native float64.
//
// Replaces the inner integral of the XLA-level JAX function
// ndpp_tpu/ops/continuum.py::cm_moments_pointwise (the chunk body at lines
// 343-518) as the port runs it: the torch op chain of
// ops/continuum.py::cm_inner_moments_ref, which materialises
// (T, chunk x nq_w, SY, QY) float64 node tensors a chunk of outer panels at
// a time, some 5,000 small launches on the continuum deck. Here one launch
// covers every outer node of a tile, and no (node x panel x GL point)
// tensor reaches device memory: the lanes of an outer node keep its L+1
// sums in registers.
//
// With s = sqrt(E)/(A+1), for one outer node w of one row:
//   the inner window [lo, hi] = [max(|w - s|, y_0), min(w + s, y_{K-1})]
//   (no work, and 0 out, where it is empty: ok_w);
//   the inner edges: lo, the data knots clipped into it (all KE, or the
//   window of nsel knots from j0 when 0 < ksel < KE), hi, and for tabular
//   angles the 2 KMU mu-knot crossing roots y = -s mu_k +- sqrt(s^2 mu_k^2
//   + w^2 - s^2), clipped;
//   at each of the nq_y GL nodes y of each live panel: x = y^2,
//   mu_cm = clip((w^2 - s^2 - x) / (2 s y)), mu_lab = clip((w^2 + s^2 - x)
//   / (2 s w)), the weight p_E p_mu wgt_y, and P_0..P_L(mu_lab) by Bonnet.
//   p_E is the knot panel's affine pdf (tabular energy) or the N-body
//   phase-space form; p_mu is Kalbach's (two-exp / expm1 form: its small-a
//   accuracy depends on it), the bilinear (E', mu) table (tabular) or 1/2.
//
// What bounds it: float64 instructions. The tiles are ~1e7-1e9 inner nodes
// (the 256-row law61cm tile 7.3e8) against a few MB of tables read and a
// (T, NW, L+1) result. Hopper has no float64 divide, square root or exp
// unit: each is a sequence of 8-25 instructions on the FP64 pipe, and the
// node of the first kernel (fb7093a) held four divisions (tabular angles) or
// three and two exps (Kalbach). What the design does:
//   - reciprocals hoisted out of the node: 1/(2 s w) once per outer node
//     (mu_lab is a product), 1/ek_w and 1/mk_w once per live panel (the
//     table's t_e and t_m are products); mu_cm takes one reciprocal of
//     max(2 s y, 1e-30), the plain version's floored denominator
//     (rcp.approx and one third-order correction, no slow path). So a
//     tabular node has no division left and a Kalbach node one, the final
//     quotient, which keeps its two-exp / expm1 form. Each panel's table
//     cell (je, jm from ymid) keeps its exact division and searchsorted
//     rule, so every panel reads the plain version's cell;
//   - sums sized by L: the order goes to a bucket LB of 3, 5 or 10 (the
//     smallest >= L), a template parameter, so P5 keeps 6 sums in registers,
//     not 11; __launch_bounds__ caps the registers so that 5 blocks of 128
//     threads (4 at LB 10; one fewer for tabular angles) stay resident per
//     SM, and no instance spills;
//   - lane groups: G lanes (a template parameter, 1, 2, 4 or 8, dispatched
//     at launch from `lanes` as L is) own one outer node. They walk the same
//     edge stream; lane j takes GL nodes j, j + G, ... of each live panel,
//     and the group's sums meet in a fixed __shfl_xor_sync butterfly, so the
//     order of each sum depends only on G and two launches give the same
//     bits. The wrapper picks the smallest G that puts ~132 x 32 warps in
//     flight (ops/lanes.lane_group): 1 on the 256-row tiles, where the
//     merge walk (59 steps and 42 roots per outer node on law61cm) is cheap
//     only when it is divided over a lane's nodes; up to 8 on the decks'
//     1-16-row tiles, where one lane per outer node filled a few SMs;
//   - a block holds kThreads / G outer nodes of one row (grid.x = row), so a
//     row's tables are loaded once per block: yk, the channel payload
//     ((KE-1) x 2 NCH affine coefficients), and for tabular angles e_knots,
//     mu_knots and mu_pdf (KE x KMU) are staged in dynamic shared memory
//     when they fit in 227 KB (cm_inner_launch decides, and says which in
//     *staged), else read in place through L1/L2 by the same code;
//   - Kalbach, isotropic and N-body panels are the stream [lo, clip(yk[j0 ..
//     j0+nsel-1]), hi]: sorted already, and live panel p lies in knot panel
//     j0 + p - 1 (the plain version's static map), so no sort and no
//     search per panel;
//   - tabular angles: the 2 KMU roots, computed as they are needed, are
//     four runs that are each monotone in mu (RootRuns), merged with the
//     knot stream, so no KMU-sized array and no sort, for any KMU; only the
//     multiset of edges has to equal torch.sort's (up to the ulps of the
//     roots), since each panel's value is a function of its two edges. Its
//     lookups keep the plain version's rule: the knot panel is the count of
//     window knots <= ymid, less one, clamped; e_knots and mu_knots panels
//     are the last j with knots[j] <= q, clamped to [0, K-2]
//     (searchsorted side="right");
//   - zero-width (dead) panels add 0 in the plain version and are skipped;
//   - the variants (angular law, N-body energy, knot window) are template
//     parameters too: 36 instances for each lane group; the GL rule
//     travels in the kernel's __grid_constant__ parameters (the constant
//     bank);
//   - the node loop is not unrolled: unrolled 4 times it ran 9% slower on
//     the law61cm tiles and 1% faster on Kalbach's. A node is 50 FP64-pipe
//     instructions with tabular angles, 100 with Kalbach's (its exp, expm1
//     and one division), 48 and a called pow with N-body energies
//     (cuobjdump -sass).
// Divergence costs little: 80-98% of a warp's lanes are live in each merge
// step on the 256-row tiles, so a work list would buy at most 1.25x.
// Tensor cores do not apply (no matrix product: each node's P_l(mu_lab)
// differs), nor does TMA: a row's tables are 216-12,952 B on the decks,
// staged once per block.
//
// Launch contract (cm_inner_launch): float arrays are float64, contiguous,
// on the current device; a pointer the variant does not read may be null.
// w is (T, NW); s, nbody_emax, c_norm are (T,); yk and e_knots (T, KE);
// payload (T, KE-1, 2 NCH) with NCH = (energy tabular) + 2 (Kalbach);
// mu_knots (KMU,) and mu_pdf (T, KE, KMU); xy/wy are the nq_y GL nodes and
// weights in HOST memory; angular is 0 kalbach, 1 tabular, 2 isotropic;
// energy 0 tabular, 1 nbody; nsel the knots per window (KE: no window);
// lanes is G (1, 2, 4 or 8). out is (T, NW, L+1); *staged is set to 1
// when the row tables are staged in shared memory, 0 when they are read
// through L2. The launch is asynchronous on `stream`; the return value is
// cudaGetLastError() right after it (0 = launched).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxL = 10;
constexpr int kMaxNqY = 64;
constexpr int kSmemMax = 232448;  // 227 KB, the most dynamic shared memory a block may hold
enum { kKalbach = 0, kTabular = 1, kIsotropic = 2 };

// The L bucket of an order: the sums a thread keeps, less one.
constexpr int bucket(int order) { return order <= 3 ? 3 : order <= 5 ? 5 : kMaxL; }
// Blocks of kThreads per SM the registers of an instance must leave room
// for: 5 (96 registers) up to L bucket 5, 4 (128) at 10, so that no
// instance spills (ptxas on sm_90a). Tabular angles (the roots' runs and the
// table cell) take one block fewer. One instance takes no bound (0): P4-5
// with tabular energies and one lane a node, which runs the law61cm tiles.
// There ptxas's own choice is 96 registers, unspilled, and timed in turns
// on one H100 the instance took 9.7% longer under the tabular rule's 4
// blocks (112 registers); its G > 1 siblings spill without a bound
// (PERF.md section 6).
constexpr int min_blocks(int ang, bool nbody, int lb, int g) {
  if (ang != kTabular) return lb <= 5 ? 5 : 4;
  return lb == 5 && !nbody && g == 1 ? 0 : lb <= 5 ? 4 : 3;
}

struct Rule {
  double x[kMaxNqY];
  double w[kMaxNqY];
};

struct Params {
  const double *w, *s, *yk, *e_knots, *payload, *mu_knots, *mu_pdf, *emax, *c_norm;
  double expo;
  int nw, ke, kmu, nsel, ncol, order, nq_y, stage;  // stage: the row tables are in shared memory
  double* out;
};

// A row's tables: in shared memory when staged, else in device memory.
struct Row {
  const double *yk, *pay, *ek, *muk, *mup;
};

// What one outer node's panels share.
struct Outer {
  double two_s, wms2, wps2, lab_den, inv_lab, cn, emax;
};

__device__ __forceinline__ double clip(double x, double lo, double hi) { return fmin(fmax(x, lo), hi); }

// 1/x for a normal x > 0, within an ulp or two: rcp.approx and one
// third-order correction, no slow path.
__device__ __forceinline__ double rcp_normal(double x) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
  const double e = fma(-x, r, 1.0);
  return fma(r, fma(e, e, e), r);
}

// The count of the leading indices of [0, n) where pred holds (pred: true,
// then false).
template <typename Pred>
__device__ __forceinline__ int count_prefix(int n, Pred pred) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (pred(m)) {
      lo = m + 1;
    } else {
      hi = m;
    }
  }
  return lo;
}

// searchsorted(a[0..n), q, side="right"): the count of a[j] <= q (a sorted).
template <typename At>
__device__ __forceinline__ int count_le(At a, int n, double q) {
  return count_prefix(n, [&a, q](int m) { return a(m) <= q; });
}

// The plain version's _panel_index_rows: the last j with knots[j] <= q,
// clamped to [0, K-2].
__device__ __forceinline__ int panel_index(const double* knots, int k, double q) {
  return min(max(count_le([knots](int j) { return knots[j]; }, k, q) - 1, 0), k - 2);
}

// P_0..P_min(L, LB) of mu_lab times wgt into acc (order: the run's L).
template <int LB>
__device__ __forceinline__ void legendre_sums(double wgt, double mu_lab, int order, double (&acc)[LB + 1]) {
  acc[0] += wgt;
  if (order >= 1) {
    double p_prev = 1.0, p_cur = mu_lab;
    acc[1] = fma(wgt, p_cur, acc[1]);
#pragma unroll
    for (int l = 1; l < LB; ++l) {
      if (l >= order) break;
      const double p_next = fma((2.0 * l + 1.0) / (l + 1.0) * mu_lab, p_cur, -(l / (l + 1.0)) * p_prev);
      acc[l + 1] = fma(wgt, p_next, acc[l + 1]);
      p_prev = p_cur;
      p_cur = p_next;
    }
  }
}

// This lane's GL nodes of one live inner panel [e0, e1] into acc.
template <int ANG, bool NBODY, int LB, int G>
__device__ __forceinline__ void panel(double e0, double e1, int jq, const Row& r, const Params& p,
                                      const Rule& rule, const Outer& n, int sub, double (&acc)[LB + 1]) {
  const double ymid = 0.5 * (e1 + e0);
  const double yhalf = 0.5 * (e1 - e0);
  const double* cf = r.pay + jq * p.ncol;
  double pe0 = 0.0, pe1 = 0.0, r0 = 0.0, r1 = 0.0, a0 = 0.0, a1 = 0.0;
  if constexpr (!NBODY) {  // p_E's (a, b) pair comes first
    pe0 = cf[0];
    pe1 = cf[1];
  }
  if constexpr (ANG == kKalbach) {  // then Kalbach's r and a pairs
    constexpr int o = NBODY ? 0 : 2;
    r0 = cf[o];
    r1 = cf[o + 1];
    a0 = cf[o + 2];
    a1 = cf[o + 3];
  }
  // tabular angles: the panel-constant (E', mu) cell of the bilinear table,
  // chosen by the plain version's exact rule, and its widths' reciprocals
  double c00 = 0.0, c01 = 0.0, c10 = 0.0, c11 = 0.0, ek0 = 0.0, ek_w = 1.0, mk0 = 0.0, mk_w = 1.0;
  double inv_ekw = 1.0, inv_mkw = 1.0;
  if constexpr (ANG == kTabular) {
    const int je = panel_index(r.ek, p.ke, ymid * ymid);
    const double mum = clip((n.wms2 - ymid * ymid) / fmax(n.two_s * ymid, 1e-30), -1.0, 1.0);
    const int jm = panel_index(r.muk, p.kmu, mum);
    const double* c = r.mup + je * p.kmu + jm;
    c00 = c[0];
    c01 = c[1];
    c10 = c[p.kmu];
    c11 = c[p.kmu + 1];
    ek0 = r.ek[je];
    ek_w = fmax(r.ek[je + 1] - ek0, 1e-30);
    mk0 = r.muk[jm];
    mk_w = fmax(r.muk[jm + 1] - mk0, 1e-30);
    inv_ekw = 1.0 / ek_w;
    inv_mkw = 1.0 / mk_w;
  }
#pragma unroll 1  // node loop
  for (int q = sub; q < p.nq_y; q += G) {
    const double y = fma(yhalf, rule.x[q], ymid);
    const double wgt_y = yhalf * rule.w[q];
    const double x = y * y;
    const double mu_lab = clip((n.wps2 - x) * n.inv_lab, -1.0, 1.0);
    double pe;
    if constexpr (NBODY) {
      pe = n.cn * y * pow(fmax(n.emax - x, 0.0), p.expo);
    } else {
      pe = fma(pe1, x, pe0);
    }
    double pa;
    if constexpr (ANG == kIsotropic) {
      pa = 0.5;
    } else {
      const double mu = clip((n.wms2 - x) * rcp_normal(fmax(n.two_s * y, 1e-30)), -1.0, 1.0);
      if constexpr (ANG == kKalbach) {
        const double rr = fma(r1, x, r0);
        const double aa = fmax(fma(a1, x, a0), 1e-12);
        const double ex = exp(aa * mu);
        const double em = expm1(aa);
        const double num = aa * ((1.0 + rr) * (ex * ex) + (1.0 - rr)) * (1.0 + em);
        pa = num / (ex * (2.0 * em * (2.0 + em)));
      } else {
        const double t_e = clip((x - ek0) * inv_ekw, 0.0, 1.0);
        const double t_m = clip((mu - mk0) * inv_mkw, 0.0, 1.0);
        const double lo_mix = c00 + t_m * (c01 - c00);
        const double hi_mix = c10 + t_m * (c11 - c10);
        pa = lo_mix + t_e * (hi_mix - lo_mix);
      }
    }
    legendre_sums<LB>(pe * pa * wgt_y, mu_lab, p.order, acc);
  }
}

// The clipped crossing roots y = -s mu_k +- sqrt(max(s^2 mu_k^2 + c, 0))
// (c = w^2 - s^2) of all KMU mu knots (ascending), both branches, in
// ascending order with no per-thread array: each branch is monotone in mu on
// at most two index ranges, so the 2 KMU roots are four runs, each walked in
// the direction in which it ascends, and merged by their heads.
//   c >= 0: both branches are non-increasing in mu everywhere (the + branch's
//     slope is -s + s^2 mu / sqrt(..) <= 0, the - branch's -s - s^2 mu /
//     sqrt(..) <= 0), so + walks k = KMU-1 .. 0 and - walks the same way.
//   c < 0: with D_k = s^2 mu_k^2 + c, A = {mu_k < 0, D_k > 0} is a prefix of
//     the knots, B = {mu_k > 0, D_k > 0} a suffix, and on F between them
//     both branches are -s mu_k (decreasing). The + branch decreases on A u F
//     and increases on B; the - branch increases on A and decreases on F u B.
// The computed D_k is monotone in |mu_k| (each rounding is), so A and B are
// exactly a prefix and a suffix. Rounding can still break a run's order by
// an ulp where two roots nearly coincide; each run keeps its running
// maximum, which moves such an edge by that ulp and keeps the edges sorted.
struct RootRuns {
  const double* muk;
  double s, s2, c, lo, hi;
  int k[4], step[4], left[4];
  double head[4];  // the next value of each run; +inf once it is spent

  __device__ __forceinline__ double root(int kk, int j) const {
    const double mk = muk[kk];
    const double sq = sqrt(fmax(fma(s2, mk * mk, c), 0.0));
    return clip(-s * mk + (j < 2 ? sq : -sq), lo, hi);
  }

  __device__ __forceinline__ RootRuns(const double* muk_, int kmu, double s_, double s2_, double c_, double lo_,
                                      double hi_)
      : muk(muk_), s(s_), s2(s2_), c(c_), lo(lo_), hi(hi_) {
    int ka = 0, kb = kmu;  // A = [0, ka), B = [kb, KMU)
    if (c < 0.0) {
      ka = count_prefix(kmu, [this](int kk) { return muk[kk] < 0.0 && fma(s2, muk[kk] * muk[kk], c) > 0.0; });
      kb = count_prefix(kmu, [this](int kk) { return !(muk[kk] > 0.0 && fma(s2, muk[kk] * muk[kk], c) > 0.0); });
    }
    // runs 0, 1: the + branch on [0, kb) down, on [kb, KMU) up;
    // runs 2, 3: the - branch on [0, ka) up, on [ka, KMU) down
    const int first[4] = {kb - 1, kb, 0, kmu - 1};
    const int stp[4] = {-1, 1, 1, -1};
    const int len[4] = {kb, kmu - kb, ka, kmu - ka};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      k[j] = first[j];
      step[j] = stp[j];
      left[j] = len[j];
      head[j] = left[j] > 0 ? root(k[j], j) : CUDART_INF;
    }
  }

  // The run with the smallest head, and that head in v.
  __device__ __forceinline__ int smallest(double& v) const {
    int j = 0;
    v = head[0];
#pragma unroll
    for (int q = 1; q < 4; ++q) {
      if (head[q] < v) {
        j = q;
        v = head[q];
      }
    }
    return j;
  }

  // Step run j past its head v (constant indices keep the runs in registers).
  __device__ __forceinline__ void pop(int j, double v) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q == j) {
        if (--left[q] > 0) {
          k[q] += step[q];
          head[q] = fmax(root(k[q], q), v);
        } else {
          head[q] = CUDART_INF;
        }
      }
    }
  }
};

template <int ANG, bool NBODY, bool WINDOW, int LB, int G>
__global__ void __launch_bounds__(kThreads, min_blocks(ANG, NBODY, LB, G))
    cm_inner_kernel(const Params p, const __grid_constant__ Rule rule) {
  extern __shared__ double smem[];
  const int t = blockIdx.x;
  const int ke = p.ke;
  Row r{p.yk + static_cast<long long>(t) * ke, p.payload + static_cast<long long>(t) * (ke - 1) * p.ncol,
        p.e_knots + static_cast<long long>(t) * ke, p.mu_knots,
        p.mu_pdf + static_cast<long long>(t) * ke * p.kmu};
  if (p.stage) {  // the whole block copies the row's tables once
    double* dst = smem;
    auto put = [&](const double*& src, int n) {
      for (int j = threadIdx.x; j < n; j += kThreads) dst[j] = src[j];
      src = dst;
      dst += n;
    };
    put(r.yk, ke);
    if (p.ncol) put(r.pay, (ke - 1) * p.ncol);
    if constexpr (ANG == kTabular) {
      put(r.ek, ke);
      put(r.muk, p.kmu);
      put(r.mup, ke * p.kmu);
    }
    __syncthreads();
  }
  const int i = (blockIdx.y * kThreads + threadIdx.x) / G;  // outer node; G lanes each
  const int sub = threadIdx.x % G;
  if (i >= p.nw) return;  // whole lane groups leave together

  const double w = p.w[static_cast<long long>(t) * p.nw + i];
  const double s = __ldg(p.s + t);
  const double lo = fmax(fabs(w - s), r.yk[0]);
  const double hi = fmin(w + s, r.yk[ke - 1]);
  double acc[LB + 1];
#pragma unroll
  for (int l = 0; l <= LB; ++l) acc[l] = 0.0;

  if (hi > lo) {
    Outer n;
    n.two_s = 2.0 * s;
    const double w2 = w * w, s2 = s * s;
    n.wms2 = w2 - s2;
    n.wps2 = w2 + s2;
    n.lab_den = fmax(2.0 * s * w, 1e-30);
    n.inv_lab = 1.0 / n.lab_den;
    n.cn = 0.0;
    n.emax = 0.0;
    if constexpr (NBODY) {
      n.cn = __ldg(p.c_norm + t);
      n.emax = __ldg(p.emax + t);
    }
    const int nsel = p.nsel;
    int j0 = 0;
    if constexpr (WINDOW) j0 = min(max(panel_index(r.yk, ke, lo), 0), ke - nsel);
    const double* yk = r.yk;
    auto knot = [yk, j0, ke](int k) { return WINDOW ? yk[min(j0 + k, ke - 1)] : yk[k]; };

    if constexpr (ANG != kTabular) {
      // [lo, clip(knots), hi]: panel p lies in knot panel j0 + p - 1
      double e0 = lo;
      for (int pn = 0; pn <= nsel; ++pn) {
        const double e1 = pn < nsel ? clip(knot(pn), lo, hi) : hi;
        if (e1 > e0) {
          panel<ANG, NBODY, LB, G>(e0, e1, min(max(j0 + pn - 1, 0), ke - 2), r, p, rule, n, sub, acc);
        }
        e0 = e1;
      }
    } else {
      // the 2 KMU clipped crossing roots as four monotone runs (see
      // RootRuns), merged with the knot stream; lo and hi bracket every
      // clipped value
      RootRuns rr(r.muk, p.kmu, s, s2, n.wms2, lo, hi);
      double e0 = lo;
      int a = 0;
      const int n_in = nsel + 2 * p.kmu;
      for (int k = 0; k <= n_in; ++k) {
        double e1 = hi;
        if (k < n_in) {
          const double ka = a < nsel ? clip(knot(a), lo, hi) : CUDART_INF;
          double rv;
          const int j = rr.smallest(rv);
          if (ka <= rv) {
            e1 = ka;
            ++a;
          } else {
            e1 = rv;
            rr.pop(j, rv);
          }
        }
        if (e1 > e0) {
          int jq = 0;
          if (p.ncol) {  // the count of window knots <= ymid, less one, clamped
            const double ymid = 0.5 * (e1 + e0);
            const int cnt = count_le(knot, nsel, ymid);
            jq = min(max(j0 + min(max(cnt - 1, 0), nsel - 2), 0), ke - 2);
          }
          panel<ANG, NBODY, LB, G>(e0, e1, jq, r, p, rule, n, sub, acc);
        }
        e0 = e1;
      }
    }
  }
  if constexpr (G > 1) {  // the group's sums meet: the same bits in every lane
    const unsigned mask = ((1u << G) - 1) << (threadIdx.x & 31 & ~(G - 1));
#pragma unroll
    for (int m = 1; m < G; m <<= 1) {
#pragma unroll
      for (int l = 0; l <= LB; ++l) acc[l] += __shfl_xor_sync(mask, acc[l], m);
    }
  }
  double* __restrict__ o = p.out + (static_cast<long long>(t) * p.nw + i) * (p.order + 1);
#pragma unroll
  for (int l = 0; l <= LB; ++l) {  // constant indices keep acc in registers; lane j writes l = j, j + G, ...
    if (l <= p.order && l % G == sub) o[l] = acc[l];
  }
}

template <int ANG, bool NBODY, bool WINDOW, int LB, int G>
int launch(const Params& p, const Rule& rule, int t_rows, int smem, cudaStream_t stream) {
  auto* kernel = cm_inner_kernel<ANG, NBODY, WINDOW, LB, G>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(t_rows, (p.nw * G + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, smem, stream>>>(p, rule);
  return 0;
}

template <int ANG, bool NBODY, bool WINDOW, int LB>
int launch_lanes(const Params& p, const Rule& rule, int t_rows, int smem, int lanes, cudaStream_t stream) {
  switch (lanes) {
    case 1: return launch<ANG, NBODY, WINDOW, LB, 1>(p, rule, t_rows, smem, stream);
    case 2: return launch<ANG, NBODY, WINDOW, LB, 2>(p, rule, t_rows, smem, stream);
    case 4: return launch<ANG, NBODY, WINDOW, LB, 4>(p, rule, t_rows, smem, stream);
    default: return launch<ANG, NBODY, WINDOW, LB, 8>(p, rule, t_rows, smem, stream);
  }
}

template <int ANG, bool NBODY, bool WINDOW>
int launch_bucket(const Params& p, const Rule& rule, int t_rows, int smem, int lanes, cudaStream_t stream) {
  const int lb = bucket(p.order);
  if (lb == 3) return launch_lanes<ANG, NBODY, WINDOW, 3>(p, rule, t_rows, smem, lanes, stream);
  if (lb == 5) return launch_lanes<ANG, NBODY, WINDOW, 5>(p, rule, t_rows, smem, lanes, stream);
  return launch_lanes<ANG, NBODY, WINDOW, kMaxL>(p, rule, t_rows, smem, lanes, stream);
}

template <int ANG>
int launch_energy(const Params& p, const Rule& rule, int t_rows, int smem, bool nbody, bool window, int lanes,
                  cudaStream_t stream) {
  if (nbody) {
    return window ? launch_bucket<ANG, true, true>(p, rule, t_rows, smem, lanes, stream)
                  : launch_bucket<ANG, true, false>(p, rule, t_rows, smem, lanes, stream);
  }
  return window ? launch_bucket<ANG, false, true>(p, rule, t_rows, smem, lanes, stream)
                : launch_bucket<ANG, false, false>(p, rule, t_rows, smem, lanes, stream);
}

}  // namespace

extern "C" int cm_inner_launch(const double* w, const double* s, const double* yk, const double* e_knots,
                               const double* payload, const double* mu_knots, const double* mu_pdf,
                               const double* nbody_emax, const double* c_norm, double nbody_expo,
                               int t_rows, int nw, int ke, int kmu, int nsel, int angular, int energy,
                               int order, int nq_y, int lanes, const double* xy, const double* wy, double* out,
                               int* staged, void* stream_handle) {
  const bool nbody = energy == 1;
  const int ncol = 2 * ((nbody ? 0 : 1) + (angular == kKalbach ? 2 : 0));
  if (t_rows <= 0 || nw <= 0 || ke < 2 || nsel < 1 || nsel > ke || order < 0 || order > kMaxL || nq_y <= 0 ||
      nq_y > kMaxNqY || angular < 0 || angular > 2 || energy < 0 || energy > 1 ||
      (lanes != 1 && lanes != 2 && lanes != 4 && lanes != 8) ||
      (static_cast<long long>(nw) * lanes + kThreads - 1) / kThreads > 65535 ||
      (angular == kTabular && kmu < 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // a row's tables: yk, the payload and, for tabular angles, e_knots, mu_knots and mu_pdf
  const long long row_bytes =
      8LL * (ke + (ke - 1) * ncol + (angular == kTabular ? ke + kmu + static_cast<long long>(ke) * kmu : 0));
  const int stage = row_bytes <= kSmemMax;
  const long long smem = stage ? row_bytes : 0;
  *staged = stage;
  Rule rule{};
  for (int q = 0; q < nq_y; ++q) {
    rule.x[q] = xy[q];
    rule.w[q] = wy[q];
  }
  const Params p{w, s, yk, e_knots, payload, mu_knots, mu_pdf, nbody_emax, c_norm, nbody_expo,
                 nw, ke, kmu, nsel, ncol, order, nq_y, stage, out};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const bool window = nsel < ke;
  int rc = 0;
  const int sm = static_cast<int>(smem);
  switch (angular) {
    case kKalbach: rc = launch_energy<kKalbach>(p, rule, t_rows, sm, nbody, window, lanes, stream); break;
    case kTabular: rc = launch_energy<kTabular>(p, rule, t_rows, sm, nbody, window, lanes, stream); break;
    default: rc = launch_energy<kIsotropic>(p, rule, t_rows, sm, nbody, window, lanes, stream); break;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
