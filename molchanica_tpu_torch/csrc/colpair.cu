// Column-pair direct-space kernel: LJ (C1 sigma clamp) + Ewald-erfc Coulomb
// over column-sorted slots, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel molchanica_tpu/ops/pallas/colpair.py::_kernel
// (pair math _pair_tile), built by make_colpair_direct_fn, in every
// instance. Triangular ones: modes lj / full / coul, force-only (K-polynomial
// Coulomb) or with energies (erfcx Coulomb), with or without the
// species-split water filter, and the has_alch instances (ALCH: the
// softcore branch of _pair_tile for pairs of the coupled molecule with the
// rest, Beutler LJ and r^2-softcore Coulomb, erfcx force, never K-poly).
// Each of them takes per-slice tables (K1a/b/d: every entry inside one
// 128-slot slice) or range tables (K1c, per_slice_k = 0: an entry is a
// whole [lo, hi) range and the kernel walks its slices, :876-878 and
// :962-966 of the TPU kernel); the slice loop runs once for a per-slice
// entry, so those instances compute what they did before it. The shard
// variant (K1f, local_shape, :1022-1029 and :1117-1122) reads its i rows
// from a block of clusters that sits at slot i_base of the j array, and
// writes the i-forces and the j reactions to two outputs. The symmetric
// table (K1e, triangular=False: the self guard :713-716, no triangle bound
// :907-908, no o2, ehalf = 0.5 :973-977) evaluates every ordered pair from
// its i side: no j reactions, and each block stores its own 64 rows, so
// those instances are deterministic. The cross variant (K1g, :814-822,
// :909-912, :1109-1114) runs the rows of a subset array (the solute)
// against the master j array: a j in the water group-id range is always
// kept, any other only when its group id exceeds the i's; i-forces and j
// reactions go to two outputs. The plain torch version of the same
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
// pair for an i skips that i's force reduction. The known cost: every slot
// of every slice of a range is tested, in- or out of the cutoff.
//
// The TPU grid ran in order, so it summed the j reactions into one
// accumulator with read-modify-writes. Here blocks run concurrently: the
// wrapper zeroes the reaction output and the kernel adds the j reactions
// (once per thread and slice) with float atomics, and the i-forces (once
// per cluster, at the end) with atomics too where they share that buffer.
// The summation order of a reaction therefore changes from run to run at
// float32 roundoff. Inside a block each warp keeps its own partial
// i-forces and energies in shared memory, summed in warp order at the end.
//
// Layouts (see ops/colpair.py::ColpairDirect):
//   rows [NC*64, 8] f32: x, y, z, q*sqrt(kC), sigma/2, 2*sqrt(eps), couple
//        mask, exclusion group id + 1 (0 = padded slot, parked at 1e6 A);
//        the i rows, slot i_base + r of the j array (i_base = 0 and
//        rows = the whole state outside the shard variant; a separate
//        subset array for the cross variant)
//   pT   [8, S] f32: the j array transposed (S j slots)
//   wl   [NC, wl_w] i32: per cluster up to wl_w/3 entries (lo, hi, code)
//        in j slots; the slices of an entry start at (lo / 128) * 128;
//        code holds (s + 1) per axis in 2 bits, s in {-1, 0, 1} box lengths
//   nw   [NC] i32 entries per cluster
//   box  [3] f32 box extents
//   prm  [64] f32: rc2, beta, beta/sqrt(pi), 2*beta/xmax (K-poly), water
//        group-id range lo/hi (the water filter's, or the cross
//        variant's), #erfcx coeffs, #K-poly coeffs, the C1 clamp
//        constants (S2_LO, S2_HI, S2_W, 0.5/S2_W, 1/S2_W), R2_MIN, the
//        softcore SC_ALPHA and SC_SIG2_MIN; [16, 40) erfcx coefficients,
//        [40, 64) K-poly coefficients
//   cpl  [1] f32 couple (ALCH only): read from device memory, because it
//        changes per lambda window and is shifted by +-h inside dH/dlambda
//
// ALCH keeps the plain version's op order where rounding could part the
// two: soft_c and r2s + soft_c without contraction, 1/(a s6 + 1) as an
// IEEE division (no --use_fast_math anywhere).
//   f_i  [NC*64, 3] f32 out: i-forces; zeroed by the caller where it is
//        the buffer of f_j (triangular, outside the shard), else stored
//   f_j  [S, 3] f32 out: j reactions, zeroed by the caller (the same
//        buffer as f_i for the triangular and symmetric tables outside the
//        shard; the symmetric table writes no reaction)
//   e    [NC, 2] f32 out: per-cluster LJ and Coulomb energies (halved for
//        the symmetric table)
#include <cuda_runtime.h>

namespace {

constexpr int ICL = 64;
constexpr int LANES = 128;
constexpr int MODE_LJ = 0;
constexpr int MODE_FULL = 1;
constexpr int MODE_COUL = 2;
constexpr int NWARP = LANES / 32;
constexpr unsigned FULL_MASK = 0xffffffffu;
// table kinds (ops/colpair.py _TABLE_*)
constexpr int TABLE_TRI = 0;
constexpr int TABLE_SYM = 1;
constexpr int TABLE_CROSS = 2;

template <int MODE, bool WANT_E, bool WFILT, bool ALCH, int TABLE>
__global__ void __launch_bounds__(LANES)
colpair_kernel(const int* __restrict__ wl, int wl_w,
               const int* __restrict__ nw, const float* __restrict__ rows,
               const float* __restrict__ pT, int S,
               const float* __restrict__ box, const float* __restrict__ prm,
               const float* __restrict__ cpl, int i_base, float* f_i,
               float* f_j, float* __restrict__ e_out) {
  constexpr bool KPOLY = !WANT_E && MODE != MODE_LJ && !ALCH;
  constexpr bool REACT = TABLE != TABLE_SYM;
  __shared__ float s_x[ICL], s_y[ICL], s_z[ICL], s_q[ICL], s_sh[ICL],
      s_se[ICL], s_g[ICL], s_cm[ICL];
  __shared__ float s_f[NWARP][3][ICL];   // per-warp partial i-forces
  __shared__ float s_c[48];
  __shared__ float s_e[NWARP][2];

  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int wp = t >> 5;
  const int cl_base = i_base + c * ICL;   // the cluster's first j slot

  if (t < ICL) {
    const float* r = rows + (size_t)(c * ICL + t) * 8;
    s_x[t] = r[0];
    s_y[t] = r[1];
    s_z[t] = r[2];
    s_q[t] = r[3];
    s_sh[t] = r[4];
    s_se[t] = r[5];
    s_cm[t] = r[6];
    s_g[t] = r[7];
  }
  for (int k = t; k < NWARP * 3 * ICL; k += LANES) (&s_f[0][0][0])[k] = 0.f;
  if (t < 48) s_c[t] = prm[16 + t];
  if (t < 2 * NWARP) (&s_e[0][0])[t] = 0.f;
  const float rc2 = prm[0], beta = prm[1], c_ex = prm[2], kscale = prm[3];
  const float wlo = prm[4], whi = prm[5];
  const int n_ex = (int)prm[6], n_kp = (int)prm[7];
  const float s2_lo = prm[8], s2_hi = prm[9], s2_w = prm[10];
  const float s2_half_inv_w = prm[11], s2_inv_w = prm[12], r2_min = prm[13];
  const float sc_alpha = prm[14], sc_sig2_min = prm[15];
  const float omc = ALCH ? 1.f - cpl[0] : 0.f;   // 1 - couple
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
    // the triangle bound applies only to the range overlapping this
    // cluster's own slots (other ranges were clamped at rebuild; in the
    // shard variant a halo range can sit below the cluster in local slots
    // while it lies above it globally)
    const bool own =
        TABLE == TABLE_TRI && (lo < cl_base + ICL) && (hi > cl_base);
    const int s_end = (hi + LANES - 1) >> 7;
    for (int sl = lo >> 7; sl < s_end; ++sl) {   // once per per-slice entry
      const int gid = (sl << 7) + t;
      const bool in_run = gid >= lo && gid < hi && gid < S;
      float jx = 0.f, jy = 0.f, jz = 0.f, jq = 0.f, jsh = 0.f, jse = 0.f;
      float gj = 0.f, jcm = 0.f;
      if (in_run) {
        jx = pT[gid] + shx;
        jy = pT[S + gid] + shy;
        jz = pT[2 * S + gid] + shz;
        jq = pT[3 * S + gid];
        jsh = pT[4 * S + gid];
        jse = pT[5 * S + gid];
        if (ALCH) jcm = pT[6 * S + gid];
        gj = pT[7 * S + gid];
      }
      // water filter, or (cross) a j in the water group-id range
      const bool is_wj = (WFILT || TABLE == TABLE_CROSS) && gj >= wlo &&
                         gj < whi;
      float fjx = 0.f, fjy = 0.f, fjz = 0.f;
      bool any_j = false;

      for (int i = 0; i < ICL; ++i) {
        const float gi = s_g[i];
        bool ok;
        if (TABLE == TABLE_CROSS) {
          ok = in_run && (is_wj || gj > gi);
        } else {
          ok = in_run && (!own || gid > cl_base + i) && gj != gi;
          if (WFILT) ok = ok && (is_wj || (gi >= wlo && gi < whi));
        }
        const float dx = s_x[i] - jx;
        const float dy = s_y[i] - jy;
        const float dz = s_z[i] - jz;
        const float r2 = dx * dx + dy * dy + dz * dz;
        ok = ok && r2 < rc2;
        if (TABLE == TABLE_SYM) ok = ok && r2 > 1e-9f;   // self guard
        float c2 = 0.f;
        if (ok) {
          const float r2s = fminf(fmaxf(r2, r2_min), rc2);
          const float inv_r = rsqrtf(r2s);
          const float inv_r2 = inv_r * inv_r;
          float dlj = 0.f, dc = 0.f;
          // softcore scales: alch = 1 - is_alch (1 - couple) per pair; the
          // sigma lanes are read in 'coul' mode too (SC_SIG2_MIN floors them)
          float alch = 1.f, a_lj = 0.f, inv_rc = inv_r;
          if (ALCH) {
            const float ci = s_cm[i];
            const float is_alch = __fsub_rn(
                __fadd_rn(ci, jcm), __fmul_rn(__fmul_rn(2.f, ci), jcm));
            alch = __fsub_rn(1.f, __fmul_rn(is_alch, omc));
            a_lj = __fmul_rn(sc_alpha, __fsub_rn(1.f, alch));
            const float sigsc = s_sh[i] + jsh;
            const float soft_c =
                __fmul_rn(fmaxf(__fmul_rn(sigsc, sigsc), sc_sig2_min), a_lj);
            inv_rc = rsqrtf(__fadd_rn(r2s, soft_c));
          }
          if (MODE != MODE_COUL) {
            const float sig = s_sh[i] + jsh;        // inputs are sigma/2
            float eps4 = s_se[i] * jse;             // inputs are 2 sqrt(eps)
            if (ALCH) eps4 = eps4 * alch;
            const float s2_raw = sig * sig * inv_r2;
            const float u = fminf(fmaxf(s2_raw - s2_lo, 0.f), s2_w);
            const float s2 = fminf(s2_raw, s2_hi) - u * u * s2_half_inv_w;
            const float gp = 1.f - u * s2_inv_w;
            float s6 = s2 * s2 * s2;
            if (ALCH) {
              // Beutler: V = eps4 (inv^2 - inv), inv = s6 / (a s6 + 1)
              const float invd =
                  __fdiv_rn(1.f, __fadd_rn(__fmul_rn(a_lj, s6), 1.f));
              s6 = s6 * invd;
              dlj = eps4 * inv_r2 * (gp * s2_raw) * (s2 * s2) * (invd * invd) *
                    (3.f - 6.f * s6);
            } else {
              dlj = eps4 * inv_r2 * (gp * s2_raw) * (s2 * s2) *
                    (3.f - 6.f * s6);
            }
            if (WANT_E) elj_acc += eps4 * (s6 * s6 - s6);
          }
          if (MODE != MODE_LJ) {
            float kqq = s_q[i] * jq;                // inputs are q sqrt(kC)
            if (ALCH) kqq = kqq * alch;
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
              if (ALCH) {
                // d/dr2 of erfc(beta r) / r_sc, r_sc^2 = r^2 + soft_c
                dc = -kqq * (c_ex * ex * inv_r * inv_rc +
                             0.5f * erfc_v * inv_rc * inv_rc * inv_rc);
              } else {
                dc = -kqq * inv_r2 * (0.5f * erfc_v * inv_r + c_ex * ex);
              }
              if (WANT_E) ec_acc += kqq * erfc_v * inv_rc;
            }
          }
          c2 = 2.f * (dlj + dc);
          any_j = true;
        }
        const float px = c2 * dx, py = c2 * dy, pz = c2 * dz;
        if (REACT) {
          fjx += px;
          fjy += py;
          fjz += pz;
        }
        // i-force: -sum over j lanes, one warp reduction per i that has a
        // pair in this warp, into the warp's own partial
        if (__any_sync(FULL_MASK, ok)) {
          float sx = px, sy = py, sz = pz;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            sx += __shfl_xor_sync(FULL_MASK, sx, o);
            sy += __shfl_xor_sync(FULL_MASK, sy, o);
            sz += __shfl_xor_sync(FULL_MASK, sz, o);
          }
          if (lane == 0) {
            s_f[wp][0][i] -= sx;
            s_f[wp][1][i] -= sy;
            s_f[wp][2][i] -= sz;
          }
        }
      }
      if (REACT && any_j) {                         // j reaction
        atomicAdd(&f_j[(size_t)gid * 3 + 0], fjx);
        atomicAdd(&f_j[(size_t)gid * 3 + 1], fjy);
        atomicAdd(&f_j[(size_t)gid * 3 + 2], fjz);
      }
    }                                           // slice loop
  }

  if (WANT_E) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      elj_acc += __shfl_xor_sync(FULL_MASK, elj_acc, o);
      ec_acc += __shfl_xor_sync(FULL_MASK, ec_acc, o);
    }
    if (lane == 0) {
      s_e[wp][0] = elj_acc;
      s_e[wp][1] = ec_acc;
    }
  }
  __syncthreads();
  // a separate i-force buffer (shard, cross) or the symmetric table's rows
  // belong to this block alone: plain stores
  const bool store = TABLE != TABLE_TRI || f_i != f_j;
  for (int k = t; k < 3 * ICL; k += LANES) {
    const int comp = k / ICL, i = k - comp * ICL;
    float v = s_f[0][comp][i];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) v += s_f[w][comp][i];
    float* dst = &f_i[(size_t)(c * ICL + i) * 3 + comp];
    if (store)
      *dst = v;
    else
      atomicAdd(dst, v);
  }
  if (WANT_E && t == 0) {
    float e0 = s_e[0][0], e1 = s_e[0][1];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) {
      e0 += s_e[w][0];
      e1 += s_e[w][1];
    }
    // the symmetric table visits every pair from both of its sites
    const float ehalf = TABLE == TABLE_SYM ? 0.5f : 1.f;
    e_out[2 * c] = ehalf * e0;
    e_out[2 * c + 1] = ehalf * e1;
  }
}

struct Args {
  int nc, wl_w, S, i_base;
  const void *wl, *nw, *rows, *pT, *box, *prm, *cpl;
  void *f_i, *f_j, *e;
  cudaStream_t st;
};

template <int MODE, bool WANT_E, bool WFILT, bool ALCH, int TABLE>
void launch(const Args& a) {
  colpair_kernel<MODE, WANT_E, WFILT, ALCH, TABLE><<<a.nc, LANES, 0, a.st>>>(
      (const int*)a.wl, a.wl_w, (const int*)a.nw, (const float*)a.rows,
      (const float*)a.pT, a.S, (const float*)a.box, (const float*)a.prm,
      (const float*)a.cpl, a.i_base, (float*)a.f_i, (float*)a.f_j,
      (float*)a.e);
}

template <int MODE, bool ALCH>
void launch_flags(int want_energy, int water_filter, const Args& a) {
  if (want_energy) {
    if (water_filter)
      launch<MODE, true, true, ALCH, TABLE_TRI>(a);
    else
      launch<MODE, true, false, ALCH, TABLE_TRI>(a);
  } else {
    if (water_filter)
      launch<MODE, false, true, ALCH, TABLE_TRI>(a);
    else
      launch<MODE, false, false, ALCH, TABLE_TRI>(a);
  }
}

// the symmetric and cross tables: mode full, no water filter
template <bool ALCH, int TABLE>
void launch_full(int want_energy, const Args& a) {
  if (want_energy)
    launch<MODE_FULL, true, false, ALCH, TABLE>(a);
  else
    launch<MODE_FULL, false, false, ALCH, TABLE>(a);
}

}  // namespace

// Launches on `stream`, allocates nothing, returns cudaGetLastError().
// table: 0 triangular, 1 symmetric (mode full, no water filter), 2 cross
// (mode full, no water filter, no alch, i_base 0; the water group-id range
// in prm[4..5]). alch selects the has_alch instances (modes full and coul
// only; `cpl` points at the couple scalar and is not read otherwise). S is
// the j array's slot count, i_base the j slot of the first i row (the i
// rows of the cross table are a separate array); f_i and f_j may be the
// same buffer (then S == nc * 64 and i_base == 0).
extern "C" int colpair_launch(int table, int mode, int want_energy,
                              int water_filter, int alch, int nc, int wl_w,
                              int S, int i_base, const void* wl,
                              const void* nw, const void* rows,
                              const void* pT, const void* box,
                              const void* prm, const void* cpl, void* f_i,
                              void* f_j, void* e, void* stream) {
  const Args a{nc, wl_w, S, i_base, wl, nw, rows, pT, box, prm, cpl,
               f_i, f_j, e, (cudaStream_t)stream};
  if (nc <= 0) return (int)cudaGetLastError();
  if (i_base < 0 || (table != TABLE_CROSS && i_base + nc * ICL > S))
    return (int)cudaErrorInvalidValue;
  if (alch && cpl == nullptr) return (int)cudaErrorInvalidValue;
  if (table == TABLE_SYM) {
    if (mode != MODE_FULL || water_filter) return (int)cudaErrorInvalidValue;
    if (alch)
      launch_full<true, TABLE_SYM>(want_energy, a);
    else
      launch_full<false, TABLE_SYM>(want_energy, a);
    return (int)cudaGetLastError();
  }
  if (table == TABLE_CROSS) {
    if (mode != MODE_FULL || water_filter || alch || i_base != 0)
      return (int)cudaErrorInvalidValue;
    launch_full<false, TABLE_CROSS>(want_energy, a);
    return (int)cudaGetLastError();
  }
  if (table != TABLE_TRI) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case MODE_LJ:
      if (alch) return (int)cudaErrorInvalidValue;
      launch_flags<MODE_LJ, false>(want_energy, water_filter, a);
      break;
    case MODE_FULL:
      if (alch)
        launch_flags<MODE_FULL, true>(want_energy, water_filter, a);
      else
        launch_flags<MODE_FULL, false>(want_energy, water_filter, a);
      break;
    case MODE_COUL:
      if (alch)
        launch_flags<MODE_COUL, true>(want_energy, water_filter, a);
      else
        launch_flags<MODE_COUL, false>(want_energy, water_filter, a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
