// Cluster-pair direct-space force: softcore LJ clipped at LJ_CLIP + Ewald
// Coulomb with the Abramowitz-Stegun 7.1.26 erfc, over MdSim's cluster-pair
// list, for NVIDIA Hopper (sm_90a), in float32 and float64.
//
// Replaces no TPU kernel: the JAX package computes this force in XLA
// (molchanica_tpu/ops/clusters.py::make_cluster_direct_force_fn). Its plain
// torch twin is ops/clusters.py::make_cluster_direct_plain, which ran the
// same pair math as 16 blocks of [NC / 16, M, 8, 8] tiles: some 1,800
// launches per evaluation, and dozens of tile temporaries in device memory.
//
// What bounds it on an H100: the pair math. The least work is each
// in-cutoff pair once at ~88 FP32 operations (benchmark/counts.py): at the
// 10,471-site duplex, ~1.72 M unordered pairs per replica, 0.009 ms for 4
// replicas at 67 TFLOP/s, while the bytes (positions, parameters and forces
// once each, ~0.38 MB a replica) take under 0.001 ms. The list is coarser
// than that: a row of M = 416 slots holds ~210 real neighbour clusters, so
// a call evaluates ~64 x 210 atom pairs per i-cluster, of which ~20% lie
// inside the cutoff. Each pair needs its own divides, square roots and exp
// of a distance, so the math is elementwise: neither wgmma nor the tensor
// cores apply.
//
// What the design does about it:
// - One block of NWARP warps per (i-cluster, replica); the replica is the
//   grid's y axis, so one launch runs every replica. A lane is (j slot of a
//   group of 4 list slots, i atom): it holds one i atom in registers and
//   loads one j atom (atom k of its slot's cluster), gathering it through
//   `order` and wrapping it into the box as the plain version does, so no
//   sorted copy of the positions is made. The warps take the row's groups
//   of 4 slots round-robin.
// - Rows are compacted (every listed cluster before every -1), so a warp
//   stops at its first group with no listed cluster: about half of the M
//   slots are never read.
// - For each of the 8 atoms of a j cluster the lanes fetch the j atom by a
//   shuffle from the lane that loaded it, test the pair with the plain
//   version's rounding (no FMA contraction in the minimum image and r^2,
//   r^2 summed in the order torch sums it on the card), so that both
//   count the same pairs, and skip the pair math when no lane of the warp
//   has a pair inside the cutoff.
// - Excluded and 1-4 pairs never enter: the rebuild flags each list
//   entry whose two clusters hold such a pair (one byte per entry;
//   ops/clusters.py; 3.7% of the duplex's listed entries), a lane loads
//   its slot's flag, and in a group of slots with a flag each lane of a
//   flagged slot looks its i atom up against the slot's 8 j atoms in the
//   topology's exclusion table (ops/exclusions.py, one word load each, as
//   K2 does; the sites from `order`) into an 8-bit row, before the pair
//   loop; a marked pair counts as outside the cutoff. An 8 x 8 bit mask
//   per entry (GROMACS's nbnxm interaction masks) would cost the list 8
//   bytes an entry, 17.5 MB for the duplex's 4 replicas, 1.4% of its peak
//   memory. The rest energy adds those pairs' own terms; a bonded pair's
//   LJ force of ~1e4-1e6 kcal/mol/A, added here and subtracted there,
//   would cancel only to a few kcal/mol/A in float32.
// - Forces stay center-side, as in the plain version (every pair is seen
//   from both of its clusters; the self tile holds each pair twice), so no
//   atomics: a lane sums its i atom's force in T, the 4 lanes of an i
//   atom are summed by two xor shuffles, the warps in warp order (in
//   double), and the block writes F[order[s]] x atom_mask once per atom.
//   The energies are
//   summed per lane in double, over the lanes by a fixed xor tree, over
//   the warps in order into the [R, NC, 2] partials; a second kernel sums
//   a replica's clusters in a fixed order and writes the half sums. The
//   output is the same bits on every launch.
// - No --use_fast_math: the pair math follows ops/clusters.py::_pair_math
//   (IEEE divides and square roots), so the kernel and its twin agree to
//   roundoff.
//
// Layouts (every array but rows, beta and box has a leading replica axis
// of n_rep):
//   x      [n, 3] T, any image (wrapped here); rows of 3, replicas
//          x_rstride elements apart (vmap's outputs pad them)
//   order  [n] int64: the atom of each sorted slot (a permutation of n)
//   nbr    [ncl, m] int64: each cluster's listed clusters, then -1
//   flags  [ncl, m] uint8: 1 where the entry's clusters hold an excluded
//          pair (above)
//   excl   [n, words] u32, shared by the replicas: bit (d - 1) % 32 of
//          word (d - 1) / 32 of row i set where sites i and i + d are an
//          excluded or 1-4 pair
//   rows   [n, 5] T: q * atom_mask, sigma, eps, couple mask, atom mask
//   couple [1] or [n_rep] T (couple_step 0 or 1); beta [1] T; box [3] T
//   f      [n, 3] T (want_force), every row written
//   e_part [ncl, 2] f64 scratch; e_out [2] T: 0.5 sum e_lj, 0.5 sum e_c
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CL = 8;                 // atoms per cluster
constexpr int GROUP = 4;              // list slots a warp takes at a time
constexpr int NWARP = 4;
constexpr int THREADS = NWARP * 32;
constexpr int SUM_THREADS = 256;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr double SOFTCORE_ALPHA = 0.5;
constexpr double LJ_CLIP = 1.0e7;
constexpr double COULOMB_CONST = 332.0637128;
constexpr double TWO_OVER_SQRT_PI = 1.1283791670955126;
constexpr double AS_P = 0.3275911;
constexpr double AS_A0 = 0.254829592;
constexpr double AS_A1 = -0.284496736;
constexpr double AS_A2 = 1.421413741;
constexpr double AS_A3 = -1.453152027;
constexpr double AS_A4 = 1.061405429;

// arithmetic without FMA contraction, where the plain version's rounding
// decides which pairs count
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float floor_(float a) { return floorf(a); }
__device__ __forceinline__ double floor_(double a) { return floor(a); }
__device__ __forceinline__ float rint_(float a) { return rintf(a); }
__device__ __forceinline__ double rint_(double a) { return rint(a); }
__device__ __forceinline__ float sqrt_(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_(double a) { return sqrt(a); }
__device__ __forceinline__ float exp_(float a) { return expf(a); }
__device__ __forceinline__ double exp_(double a) { return exp(a); }
__device__ __forceinline__ float abs_(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_(double a) { return fabs(a); }

// whether sites a and b are an excluded or 1-4 pair (ops/exclusions.py)
__device__ __forceinline__ bool excluded(const unsigned* __restrict__ excl,
                                         int words, int a, int b) {
  const int d = abs(a - b) - 1;
  const int lo = min(a, b);
  if (d < 0 || d >= 32 * words || lo < 0) return false;
  return (__ldg(excl + (size_t)lo * words + (d >> 5)) >> (d & 31)) & 1u;
}

// x - box floor(x / box): the plain version's wrap into [0, box)
template <typename T>
__device__ __forceinline__ T wrap(T v, T b) {
  return sub_rn(v, mul_rn(b, floor_(v / b)));
}

// d - box rint(d / box): ops/pbc.py::minimum_image (round half to even),
// with d / box taken as d (1 / box). The two roundings part only where
// d / box lies within an ulp of +-1/2, a pair about half a box apart, and
// the cluster backend's box is at least 2 rc, so no pair inside the cutoff
// moves
template <typename T>
__device__ __forceinline__ T image(T d, T b, T inv_b) {
  return sub_rn(d, mul_rn(b, rint_(d * inv_b)));
}

template <typename T, bool FORCE>
__global__ void __launch_bounds__(THREADS)
cluster_force_kernel(int n, int ncl, int m, const T* __restrict__ x,
                     long long x_rstride,
                     const int64_t* __restrict__ order,
                     const int64_t* __restrict__ nbr,
                     const uint8_t* __restrict__ flags,
                     const unsigned* __restrict__ excl, int excl_words,
                     const T* __restrict__ rows,
                     const T* __restrict__ couple, int couple_step,
                     const T* __restrict__ beta_p, const T* __restrict__ box,
                     T rc2, T* __restrict__ f, double* __restrict__ e_part) {
  __shared__ double s_f[NWARP][3][CL];
  __shared__ double s_e[NWARP][2];

  const int c = blockIdx.x;
  const size_t r = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int wp = t >> 5;
  const int k = lane & (CL - 1);       // this lane's i atom and j atom
  const int jg = lane >> 3;            // this lane's slot of the group
  x += r * x_rstride;
  order += r * n;
  nbr += (r * ncl + c) * (size_t)m;
  flags += (r * ncl + c) * (size_t)m;
  const T bx = box[0], by = box[1], bz = box[2];
  const T ibx = T(1) / bx, iby = T(1) / by, ibz = T(1) / bz;
  const T cp = couple[r * couple_step];
  const T beta = beta_p[0];
  const T c_ex = T(TWO_OVER_SQRT_PI) * beta;
  const T rmin = T(1e-9), r2_floor = T(1e-4), clip = T(LJ_CLIP);

  // the lane's i atom (slot c * 8 + k)
  const int64_t ai = order[(size_t)c * CL + k];
  const T* xa = x + ai * 3;
  const T* ra = rows + ai * 5;
  const T ix = wrap(xa[0], bx), iy = wrap(xa[1], by), iz = wrap(xa[2], bz);
  const T iq = ra[0], isg = ra[1], iep = ra[2], icm = ra[3];
  const T i_am = ra[4];
  const bool iv = i_am > T(0);

  // the force sums in T: with no excluded pair's ~1e6 kcal/mol/A to carry
  // they need no double (which cost 3% of the kernel's time)
  T fx = T(0), fy = T(0), fz = T(0);
  double elj = 0.0, ec = 0.0;
  for (int g = wp; g * GROUP < m; g += NWARP) {
    const int s = g * GROUP + jg;
    const int64_t cj = s < m ? nbr[s] : -1;
    if (!__any_sync(FULL_MASK, cj >= 0)) break;     // rows are compacted
    T jx = T(0), jy = T(0), jz = T(0), jq = T(0), js = T(0), je = T(0);
    T jcm = T(0);
    int jv = 0;
    int aj = -1;
    bool fl = false;                    // the entry holds an excluded pair
    if (cj >= 0) {
      fl = flags[s] != 0;
      aj = (int)order[cj * CL + k];
      const T* xb = x + aj * 3;
      const T* rb = rows + aj * 5;
      jx = wrap(xb[0], bx);
      jy = wrap(xb[1], by);
      jz = wrap(xb[2], bz);
      jq = rb[0];
      js = rb[1];
      je = rb[2];
      jcm = rb[3];
      jv = rb[4] > T(0);
    }
    // this i atom's row of the entry's exclusions (bit ja: j atom ja),
    // looked up only in groups with a flagged slot; the 8 loads are
    // independent, so their latencies overlap
    unsigned ex_row = 0;
    if (__any_sync(FULL_MASK, fl)) {                  // uniform
#pragma unroll
      for (int ja = 0; ja < CL; ++ja) {
        const int sa = __shfl_sync(FULL_MASK, aj, (lane & ~(CL - 1)) | ja);
        if (fl && excluded(excl, excl_words, (int)ai, sa))
          ex_row |= 1u << ja;
      }
    }
#pragma unroll
    for (int ja = 0; ja < CL; ++ja) {
      const int src = (lane & ~(CL - 1)) | ja;
      const T sx = __shfl_sync(FULL_MASK, jx, src);
      const T sy = __shfl_sync(FULL_MASK, jy, src);
      const T sz = __shfl_sync(FULL_MASK, jz, src);
      const int sv = __shfl_sync(FULL_MASK, jv, src);
      const T dx = image(sub_rn(ix, sx), bx, ibx);
      const T dy = image(sub_rn(iy, sy), by, iby);
      const T dz = image(sub_rn(iz, sz), bz, ibz);
      // torch's sum(d * d, -1) on the card: (x^2 + z^2) + y^2
      const T r2 = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dz, dz)),
                          mul_rn(dy, dy));
      const bool ok = iv && sv && r2 < rc2 && r2 > rmin &&
                      !((ex_row >> ja) & 1u);
      if (!__any_sync(FULL_MASK, ok)) continue;       // uniform
      const T sq = __shfl_sync(FULL_MASK, jq, src);
      const T ss = __shfl_sync(FULL_MASK, js, src);
      const T se = __shfl_sync(FULL_MASK, je, src);
      const T sc = __shfl_sync(FULL_MASK, jcm, src);
      // _pair_math, in its order of operations
      const T r2s = r2 > r2_floor ? r2 : r2_floor;
      const T inv_r2 = T(1) / r2s;
      const T sig = T(0.5) * (isg + ss);
      const T eps4 = T(4) * sqrt_(iep * se);
      const T is_alch = icm + sc - T(2) * icm * sc;
      const T cpl = T(1) - is_alch * (T(1) - cp);
      const T a_sc = T(SOFTCORE_ALPHA) * (T(1) - cpl);
      const T s2 = sig * sig * inv_r2;
      const T s6 = s2 * s2 * s2;
      const T inv_den = T(1) / (a_sc * s6 + T(1));
      const T lj_inv = s6 * inv_den;
      const T lj_pre = eps4 * cpl;
      const T e_lj_raw = lj_pre * (lj_inv * lj_inv - lj_inv);
      const bool unclipped = abs_(e_lj_raw) < clip;
      const T e_lj = e_lj_raw > clip ? clip
                                     : (e_lj_raw < -clip ? -clip : e_lj_raw);
      const T r = sqrt_(r2s);
      const T inv_r = T(1) / r;
      const T xb = beta * r;
      const T tt = T(1) / (T(1) + T(AS_P) * xb);
      const T poly = tt * (T(AS_A0) + tt * (T(AS_A1) + tt * (T(AS_A2) +
                     tt * (T(AS_A3) + tt * T(AS_A4)))));
      const T ex = exp_(-xb * xb);
      const T erfc_v = poly * ex;
      const T kqq = T(COULOMB_CONST) * iq * sq * cpl;
      const T e_c = kqq * erfc_v * inv_r;
      if (ok) {
        elj += (double)e_lj;
        ec += (double)e_c;
      }
      if (FORCE) {
        const T dlj = unclipped
            ? lj_pre * (T(2) * lj_inv - T(1)) * (inv_den * inv_den) *
                  (T(-3) * s6 * inv_r2)
            : T(0);
        const T dc = T(-0.5) * kqq * inv_r2 * (erfc_v * inv_r + c_ex * ex);
        const T coeff = ok ? dlj + dc : T(0);
        fx += coeff * dx;
        fy += coeff * dy;
        fz += coeff * dz;
      }
    }
  }

  // the warp's energies (a fixed xor tree), then the warps in order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    elj += __shfl_xor_sync(FULL_MASK, elj, o);
    ec += __shfl_xor_sync(FULL_MASK, ec, o);
  }
  if (lane == 0) {
    s_e[wp][0] = elj;
    s_e[wp][1] = ec;
  }
  if (FORCE) {
    // an i atom's 4 lanes (k, k + 8, k + 16, k + 24)
#pragma unroll
    for (int o = CL; o < 32; o <<= 1) {
      fx += __shfl_xor_sync(FULL_MASK, fx, o);
      fy += __shfl_xor_sync(FULL_MASK, fy, o);
      fz += __shfl_xor_sync(FULL_MASK, fz, o);
    }
    if (lane < CL) {
      s_f[wp][0][lane] = fx;
      s_f[wp][1][lane] = fy;
      s_f[wp][2][lane] = fz;
    }
  }
  __syncthreads();
  if (FORCE && t < CL) {
    double sx = s_f[0][0][t], sy = s_f[0][1][t], sz = s_f[0][2][t];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) {
      sx += s_f[w][0][t];
      sy += s_f[w][1][t];
      sz += s_f[w][2][t];
    }
    // lane t of warp 0 holds the i atom of slot c * 8 + t
    T* fo = f + r * n * 3 + ai * 3;
    fo[0] = T(-2) * (T)sx * i_am;
    fo[1] = T(-2) * (T)sy * i_am;
    fo[2] = T(-2) * (T)sz * i_am;
  }
  if (t < 2) {
    double acc = s_e[0][t];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) acc += s_e[w][t];
    e_part[(r * ncl + c) * 2 + t] = acc;
  }
}

// A replica's half sums: its clusters' partials in a fixed order (a
// strided run per thread, then a shared-memory tree), one block per
// replica.
template <typename T>
__global__ void __launch_bounds__(SUM_THREADS)
cluster_energy_sum(const double* __restrict__ e_part, int ncl,
                   T* __restrict__ e_out) {
  __shared__ double s[2][SUM_THREADS];
  const size_t r = blockIdx.x;
  const int t = threadIdx.x;
  const double* e = e_part + r * ncl * 2;
  double a = 0.0, b = 0.0;
  for (int c = t; c < ncl; c += SUM_THREADS) {
    a += e[2 * c];
    b += e[2 * c + 1];
  }
  s[0][t] = a;
  s[1][t] = b;
  __syncthreads();
  for (int h = SUM_THREADS / 2; h > 0; h >>= 1) {
    if (t < h) {
      s[0][t] += s[0][t + h];
      s[1][t] += s[1][t + h];
    }
    __syncthreads();
  }
  if (t < 2) e_out[r * 2 + t] = (T)(0.5 * s[t][0]);
}

template <typename T>
int launch(int want_force, int n_rep, int n, int ncl, int m,
           int couple_step, long long x_rstride, double rc2, const void* x,
           const void* order, const void* nbr, const void* flags,
           const void* excl, int excl_words, const void* rows,
           const void* couple, const void* beta, const void* box, void* f,
           void* e_part, void* e_out, cudaStream_t stream) {
  const dim3 grid(ncl, n_rep);
  if (want_force)
    cluster_force_kernel<T, true><<<grid, THREADS, 0, stream>>>(
        n, ncl, m, (const T*)x, x_rstride, (const int64_t*)order,
        (const int64_t*)nbr, (const uint8_t*)flags, (const unsigned*)excl,
        excl_words, (const T*)rows, (const T*)couple, couple_step,
        (const T*)beta, (const T*)box, (T)rc2, (T*)f, (double*)e_part);
  else
    cluster_force_kernel<T, false><<<grid, THREADS, 0, stream>>>(
        n, ncl, m, (const T*)x, x_rstride, (const int64_t*)order,
        (const int64_t*)nbr, (const uint8_t*)flags, (const unsigned*)excl,
        excl_words, (const T*)rows, (const T*)couple, couple_step,
        (const T*)beta, (const T*)box, (T)rc2, nullptr, (double*)e_part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cluster_energy_sum<T><<<n_rep, SUM_THREADS, 0, stream>>>(
      (const double*)e_part, ncl, (T*)e_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the pair kernel and the energy sum on `stream` for n_rep
// replicas of one plan (float64 when dtype64, else float32), allocates
// nothing, returns cudaGetLastError() (or cudaErrorInvalidValue for
// arguments it does not take). e_part holds n_rep * ncl * 2 doubles; f is
// ignored unless want_force.
extern "C" int cluster_force_launch(int dtype64, int want_force, int n_rep,
                                    int n, int ncl, int m, int couple_step,
                                    long long x_rstride, double rc2,
                                    const void* x,
                                    const void* order, const void* nbr,
                                    const void* flags, const void* excl,
                                    int excl_words, const void* rows,
                                    const void* couple, const void* beta,
                                    const void* box, void* f, void* e_part,
                                    void* e_out, void* stream) {
  if (n_rep <= 0 || n_rep > 65535 || ncl <= 0 || n != ncl * CL || m <= 0
      || (couple_step != 0 && couple_step != 1)
      || (n_rep > 1 && x_rstride < 3LL * n)
      || (want_force && f == nullptr) || excl == nullptr
      || excl_words <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return dtype64
      ? launch<double>(want_force, n_rep, n, ncl, m, couple_step, x_rstride,
                       rc2, x, order, nbr, flags, excl, excl_words, rows,
                       couple, beta, box, f, e_part, e_out, s)
      : launch<float>(want_force, n_rep, n, ncl, m, couple_step, x_rstride,
                      rc2, x, order, nbr, flags, excl, excl_words, rows,
                      couple, beta, box, f, e_part, e_out, s);
}
