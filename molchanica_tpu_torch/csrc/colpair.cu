// Column-pair direct-space kernel: LJ (C1 sigma clamp) + Ewald-erfc Coulomb
// over column-sorted slots, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel molchanica_tpu/ops/pallas/colpair.py::_kernel
// (pair math _pair_tile), built by make_colpair_direct_fn, in its
// triangular per-slice-table instances: modes lj / full / coul, force-only
// (K-polynomial Coulomb) or with energies (erfcx Coulomb), with or without
// the species-split water filter. The plain torch version of the same
// function is ops/colpair.py::colpair_plain.
//
// What bounds it on an H100: the FP32 pair math. Per in-cutoff pair it
// spends ~50-80 FP32 operations (rsqrt, a degree-12 Horner, the LJ clamp)
// against ~100 bytes of inputs per 64-row cluster and slice, so the bytes
// (rows, table and forces: a few MB a call, ~1 us at 3.35 TB/s) are far
// below the operations (tens of MFLOP a call, tens of us at 67 TFLOP/s).
// What its design does about that: one block per 64-site i-cluster and one
// thread per j lane of the current 128-slot slice, so each j row is read
// once per slice (coalesced, from the [8, S] transposed array) and each
// i row comes from shared memory; a warp whose 32 lanes hold no in-cutoff
// pair for an i skips that i's force reduction.
//
// The TPU grid ran in order, so it summed the j reactions into one
// accumulator with read-modify-writes. Here blocks run concurrently: the
// wrapper zeroes f [S, 3] and the kernel adds both the i-forces (once per
// cluster, at the end) and the j reactions (once per thread and slice)
// with float atomics. The summation order therefore changes from run to
// run at float32 roundoff.
//
// Layouts (see ops/colpair.py::ColpairDirect):
//   rows [S, 8] f32: x, y, z, q*sqrt(kC), sigma/2, 2*sqrt(eps), couple
//        mask, exclusion group id + 1 (0 = padded slot, parked at 1e6 A)
//   pT   [8, S] f32: rows transposed (the j side)
//   wl   [NC, wl_w] i32: per cluster up to wl_w/3 entries (lo, hi, code),
//        each inside one 128-slot slice starting at (lo / 128) * 128;
//        code holds (s + 1) per axis in 2 bits, s in {-1, 0, 1} box lengths
//   nw   [NC] i32 entries per cluster
//   box  [3] f32 box extents
//   prm  [64] f32: rc2, beta, beta/sqrt(pi), 2*beta/xmax (K-poly), water
//        group-id range lo/hi, #erfcx coeffs, #K-poly coeffs, the C1 clamp
//        constants (S2_LO, S2_HI, S2_W, 0.5/S2_W, 1/S2_W), R2_MIN;
//        [16, 40) erfcx coefficients, [40, 64) K-poly coefficients
//   f    [S, 3] f32 out, zeroed by the caller
//   e    [NC, 2] f32 out: per-cluster LJ and Coulomb energies
#include <cuda_runtime.h>

namespace {

constexpr int ICL = 64;
constexpr int LANES = 128;
constexpr int MODE_LJ = 0;
constexpr int MODE_FULL = 1;
constexpr int MODE_COUL = 2;
constexpr unsigned FULL_MASK = 0xffffffffu;

template <int MODE, bool WANT_E, bool WFILT>
__global__ void __launch_bounds__(LANES)
colpair_kernel(const int* __restrict__ wl, int wl_w,
               const int* __restrict__ nw, const float* __restrict__ rows,
               const float* __restrict__ pT, int S,
               const float* __restrict__ box, const float* __restrict__ prm,
               float* __restrict__ f, float* __restrict__ e_out) {
  constexpr bool KPOLY = !WANT_E && MODE != MODE_LJ;
  __shared__ float s_x[ICL], s_y[ICL], s_z[ICL], s_q[ICL], s_sh[ICL],
      s_se[ICL], s_g[ICL];
  __shared__ float s_f[3][ICL];
  __shared__ float s_c[48];
  __shared__ float s_e[2];

  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int cl_base = c * ICL;

  if (t < ICL) {
    const float* r = rows + (size_t)(cl_base + t) * 8;
    s_x[t] = r[0];
    s_y[t] = r[1];
    s_z[t] = r[2];
    s_q[t] = r[3];
    s_sh[t] = r[4];
    s_se[t] = r[5];
    s_g[t] = r[7];
    s_f[0][t] = 0.f;
    s_f[1][t] = 0.f;
    s_f[2][t] = 0.f;
  }
  if (t < 48) s_c[t] = prm[16 + t];
  if (t < 2) s_e[t] = 0.f;
  const float rc2 = prm[0], beta = prm[1], c_ex = prm[2], kscale = prm[3];
  const float wlo = prm[4], whi = prm[5];
  const int n_ex = (int)prm[6], n_kp = (int)prm[7];
  const float s2_lo = prm[8], s2_hi = prm[9], s2_w = prm[10];
  const float s2_half_inv_w = prm[11], s2_inv_w = prm[12], r2_min = prm[13];
  const float lx = box[0], ly = box[1], lz = box[2];
  __syncthreads();

  const int n = nw[c];
  const int* ent = wl + (size_t)c * wl_w;
  float elj_acc = 0.f, ec_acc = 0.f;

  for (int w = 0; w < n; ++w) {
    const int lo = ent[3 * w];
    const int hi = ent[3 * w + 1];
    const int code = ent[3 * w + 2];
    const float shx = (float)((code & 3) - 1) * lx;
    const float shy = (float)(((code >> 2) & 3) - 1) * ly;
    const float shz = (float)(((code >> 4) & 3) - 1) * lz;
    const int gid = ((lo >> 7) << 7) + t;
    // the triangle bound applies only to the range overlapping this
    // cluster's own slots (other ranges were clamped at rebuild)
    const bool own = (lo < cl_base + ICL) && (hi > cl_base);
    const bool in_run = gid >= lo && gid < hi && gid < S;
    float jx = 0.f, jy = 0.f, jz = 0.f, jq = 0.f, jsh = 0.f, jse = 0.f;
    float gj = 0.f;
    if (in_run) {
      jx = pT[gid] + shx;
      jy = pT[S + gid] + shy;
      jz = pT[2 * S + gid] + shz;
      jq = pT[3 * S + gid];
      jsh = pT[4 * S + gid];
      jse = pT[5 * S + gid];
      gj = pT[7 * S + gid];
    }
    const bool is_wj = WFILT && gj >= wlo && gj < whi;
    float fjx = 0.f, fjy = 0.f, fjz = 0.f;
    bool any_j = false;

    for (int i = 0; i < ICL; ++i) {
      const float gi = s_g[i];
      bool ok = in_run && (!own || gid > cl_base + i) && gj != gi;
      if (WFILT) ok = ok && (is_wj || (gi >= wlo && gi < whi));
      const float dx = s_x[i] - jx;
      const float dy = s_y[i] - jy;
      const float dz = s_z[i] - jz;
      const float r2 = dx * dx + dy * dy + dz * dz;
      ok = ok && r2 < rc2;
      float c2 = 0.f;
      if (ok) {
        const float r2s = fminf(fmaxf(r2, r2_min), rc2);
        const float inv_r = rsqrtf(r2s);
        const float inv_r2 = inv_r * inv_r;
        float dlj = 0.f, dc = 0.f;
        if (MODE != MODE_COUL) {
          const float sig = s_sh[i] + jsh;        // inputs are sigma/2
          const float eps4 = s_se[i] * jse;       // inputs are 2 sqrt(eps)
          const float s2_raw = sig * sig * inv_r2;
          const float u = fminf(fmaxf(s2_raw - s2_lo, 0.f), s2_w);
          const float s2 = fminf(s2_raw, s2_hi) - u * u * s2_half_inv_w;
          const float gp = 1.f - u * s2_inv_w;
          const float s6 = s2 * s2 * s2;
          dlj = eps4 * inv_r2 * (gp * s2_raw) * (s2 * s2) * (3.f - 6.f * s6);
          if (WANT_E) elj_acc += eps4 * (s6 * s6 - s6);
        }
        if (MODE != MODE_LJ) {
          const float kqq = s_q[i] * jq;          // inputs are q sqrt(kC)
          if (KPOLY) {
            const float tt = (r2s * inv_r) * kscale - 1.f;
            float kk = s_c[24 + n_kp - 1];
            for (int m = n_kp - 2; m >= 0; --m) kk = kk * tt + s_c[24 + m];
            dc = -kqq * (kk * (inv_r2 * inv_r));
          } else {
            const float x = beta * (r2s * inv_r);
            const float ex = expf(-x * x);
            float g = s_c[n_ex - 1];
            for (int m = n_ex - 2; m >= 0; --m) g = g * x + s_c[m];
            const float erfc_v = g * ex;
            dc = -kqq * inv_r2 * (0.5f * erfc_v * inv_r + c_ex * ex);
            if (WANT_E) ec_acc += kqq * erfc_v * inv_r;
          }
        }
        c2 = 2.f * (dlj + dc);
        any_j = true;
      }
      const float px = c2 * dx, py = c2 * dy, pz = c2 * dz;
      fjx += px;
      fjy += py;
      fjz += pz;
      // i-force: -sum over j lanes, one warp reduction per i that has a
      // pair in this warp
      if (__any_sync(FULL_MASK, ok)) {
        float sx = px, sy = py, sz = pz;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          sx += __shfl_xor_sync(FULL_MASK, sx, o);
          sy += __shfl_xor_sync(FULL_MASK, sy, o);
          sz += __shfl_xor_sync(FULL_MASK, sz, o);
        }
        if (lane == 0) {
          atomicAdd(&s_f[0][i], -sx);
          atomicAdd(&s_f[1][i], -sy);
          atomicAdd(&s_f[2][i], -sz);
        }
      }
    }
    if (any_j) {                                  // j reaction
      atomicAdd(&f[(size_t)gid * 3 + 0], fjx);
      atomicAdd(&f[(size_t)gid * 3 + 1], fjy);
      atomicAdd(&f[(size_t)gid * 3 + 2], fjz);
    }
  }

  if (WANT_E) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      elj_acc += __shfl_xor_sync(FULL_MASK, elj_acc, o);
      ec_acc += __shfl_xor_sync(FULL_MASK, ec_acc, o);
    }
    if (lane == 0) {
      atomicAdd(&s_e[0], elj_acc);
      atomicAdd(&s_e[1], ec_acc);
    }
  }
  __syncthreads();
  for (int k = t; k < 3 * ICL; k += LANES) {
    const int comp = k / ICL, i = k - comp * ICL;
    atomicAdd(&f[(size_t)(cl_base + i) * 3 + comp], s_f[comp][i]);
  }
  if (WANT_E && t == 0) {
    e_out[2 * c] = s_e[0];
    e_out[2 * c + 1] = s_e[1];
  }
}

template <int MODE, bool WANT_E, bool WFILT>
void launch(int nc, int wl_w, int S, const void* wl, const void* nw,
            const void* rows, const void* pT, const void* box,
            const void* prm, void* f, void* e, cudaStream_t st) {
  colpair_kernel<MODE, WANT_E, WFILT><<<nc, LANES, 0, st>>>(
      (const int*)wl, wl_w, (const int*)nw, (const float*)rows,
      (const float*)pT, S, (const float*)box, (const float*)prm, (float*)f,
      (float*)e);
}

template <int MODE>
void launch_mode(int want_energy, int water_filter, int nc, int wl_w, int S,
                 const void* wl, const void* nw, const void* rows,
                 const void* pT, const void* box, const void* prm, void* f,
                 void* e, cudaStream_t st) {
  if (want_energy) {
    if (water_filter)
      launch<MODE, true, true>(nc, wl_w, S, wl, nw, rows, pT, box, prm, f, e,
                               st);
    else
      launch<MODE, true, false>(nc, wl_w, S, wl, nw, rows, pT, box, prm, f,
                                e, st);
  } else {
    if (water_filter)
      launch<MODE, false, true>(nc, wl_w, S, wl, nw, rows, pT, box, prm, f,
                                e, st);
    else
      launch<MODE, false, false>(nc, wl_w, S, wl, nw, rows, pT, box, prm, f,
                                 e, st);
  }
}

}  // namespace

// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int colpair_launch(int mode, int want_energy, int water_filter,
                              int nc, int wl_w, int S, const void* wl,
                              const void* nw, const void* rows,
                              const void* pT, const void* box,
                              const void* prm, void* f, void* e,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nc <= 0) return (int)cudaGetLastError();
  switch (mode) {
    case MODE_LJ:
      launch_mode<MODE_LJ>(want_energy, water_filter, nc, wl_w, S, wl, nw,
                           rows, pT, box, prm, f, e, st);
      break;
    case MODE_FULL:
      launch_mode<MODE_FULL>(want_energy, water_filter, nc, wl_w, S, wl, nw,
                             rows, pT, box, prm, f, e, st);
      break;
    case MODE_COUL:
      launch_mode<MODE_COUL>(want_energy, water_filter, nc, wl_w, S, wl, nw,
                             rows, pT, box, prm, f, e, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
