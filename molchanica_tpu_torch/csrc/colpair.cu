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
// whole [lo, hi) range, :876-878 and :962-966 of the TPU kernel). The
// shard variant (K1f, local_shape, :1022-1029 and :1117-1122) reads its i
// rows from a block of clusters that sits at slot i_base of the j array,
// and writes the i-forces and the j reactions to two outputs. The
// symmetric table (K1e, triangular=False: the self guard :713-716, no
// triangle bound :907-908, no o2, ehalf = 0.5 :973-977) evaluates every
// ordered pair from its i side and writes no j reaction. The cross variant
// (K1g, :814-822, :909-912, :1109-1114) runs the rows of a subset array
// (the solute) against the master j array: a j in the water group-id range
// is always kept, any other only when its group id exceeds the i's;
// i-forces and j reactions go to two outputs. The plain torch version of
// the same function is ops/colpair.py::colpair_plain, and the plain model
// of this kernel's schedule is ops/colpair.py::colpair_work.
//
// What bounds it on an H100: the FP32 pair math. Per in-cutoff pair it
// spends ~45-110 FP32 operations (rsqrt, exp, a Horner of degree 8-12, the
// LJ clamp) against a few MB of rows, tables and forces a call, so the
// operations (tens of MFLOP, tens of us at 67 TFLOP/s) lie far above the
// bytes (~1 us at 3.35 TB/s). Each pair needs its own rsqrt and exp of a
// distance, so the math is elementwise: neither wgmma nor the tensor cores
// apply. What sets the time beside the math: only ~4-5% of the slot pairs
// a cluster's window names lie inside the cutoff, and a cluster's window
// is ~10-90 slices long.
//
// What the design does about it:
// - Work split. The grid is (cluster, part): `parts` blocks per 64-site
//   i-cluster (ops/colpair.py::colpair_parts, from static shapes), each of
//   NWARP warps. A cluster's window is cut into 32-slot j chunks, each
//   clipped to its entry's [lo, hi) (a range entry gives many chunks), and
//   chunk k of the cluster goes to warp k mod (parts * NWARP) of the
//   cluster's blocks. No launch waits on one cluster's serial walk; warps
//   without a chunk only write zero partials.
// - Compaction. A warp holds one j per lane and tests its chunk against the
//   cluster's 64 i rows (shared memory): the masks (group ids, the triangle
//   bound on own-slot entries, the water filter, cross's group-id order)
//   and r^2 < rc^2, with the same float32 expression as the pair math. The
//   (i, j) pairs that pass are queued in shared memory, warp-locally, by
//   ballot + popc, in (i, j) order. The pair math then runs on full
//   32-lane batches of the queue (only a chunk's last batch is partial),
//   the j data shuffled from the lane that loaded it.
// - Reductions. The i-forces of a batch are summed per i by a fixed-order
//   segmented reduction over the lanes (the queue is sorted by i), and one
//   lane per i adds the sum to its warp's shared partial. The j reactions
//   of a batch are summed per j, in lane order, by the first lane of each
//   group of lanes that share the j (__match_any_sync), into a per-warp
//   shared row; they go to device memory once per j per chunk (a float
//   atomic). No shared-memory float atomics: lanes that share an address
//   serialize on them. At the end each block writes its warps' summed
//   i-forces and energies to its part's slot of the `scratch` partials
//   (made by the wrapper), and a second kernel sums the parts in part
//   order into f_i and e.
// - Determinism. Queue order, batch order, the segmented and warp sums and
//   the part sum are fixed, so the symmetric table (no reactions) gives the
//   same bits on every launch. The reactions (triangular, shard, cross) are
//   float atomics, whose order changes from run to run at float32 roundoff;
//   so do those instances' i-forces where they share the reaction buffer.
//
// Layouts (see ops/colpair.py::ColpairDirect):
//   rows [NC*64, 8] f32: x, y, z, q*sqrt(kC), sigma/2, 2*sqrt(eps), couple
//        mask, exclusion group id + 1 (0 = padded slot, parked at 1e6 A);
//        the i rows, slot i_base + r of the j array (i_base = 0 and
//        rows = the whole state outside the shard variant; a separate
//        subset array for the cross variant)
//   pT   [8, S] f32: the j array transposed (S j slots)
//   wl   [NC, wl_w] i32: per cluster up to wl_w/3 entries (lo, hi, code)
//        in j slots; code holds (s + 1) per axis in 2 bits, s in
//        {-1, 0, 1} box lengths
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
//   f_i  [NC*64, 3] f32 out: i-forces, written by the part sum (added to
//        the reactions where it is the buffer of f_j: triangular, outside
//        the shard)
//   f_j  [S, 3] f32 out: j reactions, zeroed by the caller (the same
//        buffer as f_i for the triangular and symmetric tables outside the
//        shard; the symmetric table writes no reaction)
//   e    [NC, 2] f32 out: per-cluster LJ and Coulomb energies (halved for
//        the symmetric table), written by the part sum
//   scratch [parts * NC * (192 + 2)] f32: per-(part, cluster) i-forces
//        [64, 3], then per-(part, cluster) energies [2]
//   counts  [1] i64 or null: when set, the kernel adds the number of pairs
//        that passed the cutoff and mask test (one atomic per warp)
//
// ALCH keeps the plain version's op order where rounding could part the
// two: soft_c and r2s + soft_c without contraction, 1/(a s6 + 1) as an
// IEEE division (no --use_fast_math anywhere). r^2 is one fixed fma
// expression, the same in the test and in the math.
#include <cuda_runtime.h>

namespace {

constexpr int ICL = 64;
constexpr int CHUNK = 32;             // j slots per chunk (one per lane)
constexpr int NWARP = 4;              // warps per block
constexpr int THREADS = NWARP * 32;
constexpr int QCAP = ICL * CHUNK;     // a chunk's candidate pairs
constexpr int ROW_F = 3 * ICL;        // floats of one cluster's i-forces
constexpr int MODE_LJ = 0;
constexpr int MODE_FULL = 1;
constexpr int MODE_COUL = 2;
constexpr unsigned FULL_MASK = 0xffffffffu;
// table kinds (ops/colpair.py _TABLE_*)
constexpr int TABLE_TRI = 0;
constexpr int TABLE_SYM = 1;
constexpr int TABLE_CROSS = 2;

__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return fmaf(dz, dz, fmaf(dy, dy, dx * dx));
}

template <int MODE, bool WANT_E, bool WFILT, bool ALCH, int TABLE>
__global__ void __launch_bounds__(THREADS)
colpair_kernel(const int* __restrict__ wl, int wl_w,
               const int* __restrict__ nw, const float* __restrict__ rows,
               const float* __restrict__ pT, int S,
               const float* __restrict__ box, const float* __restrict__ prm,
               const float* __restrict__ cpl, int i_base, float* f_j,
               float* __restrict__ part,
               unsigned long long* __restrict__ counts) {
  constexpr bool KPOLY = !WANT_E && MODE != MODE_LJ && !ALCH;
  constexpr bool REACT = TABLE != TABLE_SYM;
  __shared__ float4 s_pos[ICL];           // x, y, z, group id
  __shared__ float4 s_par[ICL];           // q, sigma/2, 2 sqrt(eps), couple
  __shared__ float s_c[48];
  __shared__ float s_f[NWARP][3][ICL];    // per-warp partial i-forces
  __shared__ float s_fj[NWARP][3][CHUNK]; // per-warp reactions of a chunk
  __shared__ float s_p[NWARP][3][32];     // a batch's pair forces, by lane
  __shared__ unsigned short s_q[NWARP][QCAP];   // (i << 5) | j lane
  __shared__ float s_e[NWARP][2];

  const int c = blockIdx.x;
  const int nc = gridDim.x;
  const int p_idx = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int wp = t >> 5;
  const int cl_base = i_base + c * ICL;   // the cluster's first j slot

  if (t < ICL) {
    const float* r = rows + (size_t)(c * ICL + t) * 8;
    s_pos[t] = make_float4(r[0], r[1], r[2], r[7]);
    s_par[t] = make_float4(r[3], r[4], r[5], r[6]);
  }
  for (int k = t; k < NWARP * 3 * ICL; k += THREADS) (&s_f[0][0][0])[k] = 0.f;
  for (int k = t; k < NWARP * 3 * CHUNK; k += THREADS)
    (&s_fj[0][0][0])[k] = 0.f;
  if (t < 48) s_c[t] = prm[16 + t];
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
  const int G = gridDim.y * NWARP;        // warps sharing this cluster
  const int gw = p_idx * NWARP + wp;      // this warp among them
  const unsigned lt_mask = (1u << lane) - 1u;
  unsigned short* q = s_q[wp];
  float elj_acc = 0.f, ec_acc = 0.f;
  unsigned long long n_pairs = 0;
  int k_base = 0;                         // chunks of earlier entries

  for (int e0 = 0; e0 < n; e0 += 32) {    // 32 entries per round, one a lane
    const int e = e0 + lane;
    int lo = 0, hi = 0, code = 0;
    if (e < n) {
      lo = ent[3 * e];
      hi = ent[3 * e + 1];
      code = ent[3 * e + 2];
    }
    const int nch = hi > lo ? (hi - lo + CHUNK - 1) / CHUNK : 0;
    int incl = nch;                       // inclusive scan of chunk counts
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, incl, o);
      if (lane >= o) incl += y;
    }
    const int k0 = k_base + incl - nch;   // the entry's first chunk
    k_base += __shfl_sync(FULL_MASK, incl, 31);
    // this warp's first chunk of the entry: the least k >= k0, k = gw mod G
    const int first = k0 + ((gw - k0 % G) % G + G) % G;
    unsigned todo = __ballot_sync(FULL_MASK, first < k0 + nch);
    while (todo) {
      const int src = __ffs((int)todo) - 1;
      todo &= todo - 1;
      const int e_lo = __shfl_sync(FULL_MASK, lo, src);
      const int e_hi = __shfl_sync(FULL_MASK, hi, src);
      const int e_code = __shfl_sync(FULL_MASK, code, src);
      const int e_k0 = __shfl_sync(FULL_MASK, k0, src);
      const int e_end = e_k0 + __shfl_sync(FULL_MASK, nch, src);
      const float shx = (float)((e_code & 3) - 1) * lx;
      const float shy = (float)(((e_code >> 2) & 3) - 1) * ly;
      const float shz = (float)(((e_code >> 4) & 3) - 1) * lz;
      // the triangle bound applies only to the range overlapping this
      // cluster's own slots (other ranges were clamped at rebuild; in the
      // shard variant a halo range can sit below the cluster in local slots
      // while it lies above it globally)
      const bool own =
          TABLE == TABLE_TRI && (e_lo < cl_base + ICL) && (e_hi > cl_base);

      for (int k = __shfl_sync(FULL_MASK, first, src); k < e_end; k += G) {
        const int c_lo = e_lo + (k - e_k0) * CHUNK;
        const int gid = c_lo + lane;
        const bool in_run = gid < e_hi && gid < S;
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
        const bool is_wj =
            (WFILT || TABLE == TABLE_CROSS) && gj >= wlo && gj < whi;

        // the test: every i of the cluster against this lane's j; the
        // pairs that pass are queued in (i, j) order
        int cnt = 0;
        bool hit = false;
#pragma unroll 8
        for (int i = 0; i < ICL; ++i) {
          const float4 pi = s_pos[i];
          const float gi = pi.w;
          bool ok;
          if (TABLE == TABLE_CROSS) {
            ok = in_run && (is_wj || gj > gi);
          } else {
            ok = in_run && (!own || gid > cl_base + i) && gj != gi;
            if (WFILT) ok = ok && (is_wj || (gi >= wlo && gi < whi));
          }
          const float r2 = dist2(pi.x - jx, pi.y - jy, pi.z - jz);
          ok = ok && r2 < rc2;
          if (TABLE == TABLE_SYM) ok = ok && r2 > 1e-9f;   // self guard
          const unsigned m = __ballot_sync(FULL_MASK, ok);
          if (ok)
            q[cnt + __popc(m & lt_mask)] = (unsigned short)((i << 5) | lane);
          cnt += __popc(m);
          hit = hit || ok;
        }
        __syncwarp();
        n_pairs += cnt;

        // the pair math on 32-lane batches of the queue
        for (int b = 0; b < cnt; b += 32) {
          const bool valid = b + lane < cnt;
          const int qe = valid ? (int)q[b + lane] : 0;
          const int i = qe >> 5;
          const int jl = qe & 31;
          const float bjx = __shfl_sync(FULL_MASK, jx, jl);
          const float bjy = __shfl_sync(FULL_MASK, jy, jl);
          const float bjz = __shfl_sync(FULL_MASK, jz, jl);
          const float bjq = __shfl_sync(FULL_MASK, jq, jl);
          const float bjsh = __shfl_sync(FULL_MASK, jsh, jl);
          const float bjse = __shfl_sync(FULL_MASK, jse, jl);
          const float bjcm = ALCH ? __shfl_sync(FULL_MASK, jcm, jl) : 0.f;
          float px = 0.f, py = 0.f, pz = 0.f;
          if (valid) {
            const float4 pi = s_pos[i];
            const float4 ai = s_par[i];   // q, sigma/2, 2 sqrt(eps), couple
            const float dx = pi.x - bjx;
            const float dy = pi.y - bjy;
            const float dz = pi.z - bjz;
            const float r2 = dist2(dx, dy, dz);
            const float r2s = fminf(fmaxf(r2, r2_min), rc2);
            const float inv_r = rsqrtf(r2s);
            const float inv_r2 = inv_r * inv_r;
            float dlj = 0.f, dc = 0.f;
            // softcore scales: alch = 1 - is_alch (1 - couple) per pair; the
            // sigma lanes are read in 'coul' mode too (SC_SIG2_MIN floors
            // them)
            float alch = 1.f, a_lj = 0.f, inv_rc = inv_r;
            if (ALCH) {
              const float ci = ai.w;
              const float is_alch = __fsub_rn(
                  __fadd_rn(ci, bjcm), __fmul_rn(__fmul_rn(2.f, ci), bjcm));
              alch = __fsub_rn(1.f, __fmul_rn(is_alch, omc));
              a_lj = __fmul_rn(sc_alpha, __fsub_rn(1.f, alch));
              const float sigsc = ai.y + bjsh;
              const float soft_c =
                  __fmul_rn(fmaxf(__fmul_rn(sigsc, sigsc), sc_sig2_min), a_lj);
              inv_rc = rsqrtf(__fadd_rn(r2s, soft_c));
            }
            if (MODE != MODE_COUL) {
              const float sig = ai.y + bjsh;        // inputs are sigma/2
              float eps4 = ai.z * bjse;             // inputs are 2 sqrt(eps)
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
                dlj = eps4 * inv_r2 * (gp * s2_raw) * (s2 * s2) *
                      (invd * invd) * (3.f - 6.f * s6);
              } else {
                dlj = eps4 * inv_r2 * (gp * s2_raw) * (s2 * s2) *
                      (3.f - 6.f * s6);
              }
              if (WANT_E) elj_acc += eps4 * (s6 * s6 - s6);
            }
            if (MODE != MODE_LJ) {
              float kqq = ai.x * bjq;               // inputs are q sqrt(kC)
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
            const float c2 = 2.f * (dlj + dc);
            px = c2 * dx;
            py = c2 * dy;
            pz = c2 * dz;
          }
          // i-force: a segmented sum over the lanes of each i (the queue is
          // sorted by i; a spent lane is a segment of its own), in a fixed
          // order, then one add to the warp's partial by the segment's
          // first lane
          const int key = valid ? i : ICL + lane;
          float sx = px, sy = py, sz = pz;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int ko = __shfl_down_sync(FULL_MASK, key, o);
            const float ax = __shfl_down_sync(FULL_MASK, sx, o);
            const float ay = __shfl_down_sync(FULL_MASK, sy, o);
            const float az = __shfl_down_sync(FULL_MASK, sz, o);
            if (lane + o < 32 && ko == key) {
              sx += ax;
              sy += ay;
              sz += az;
            }
          }
          const int k_prev = __shfl_up_sync(FULL_MASK, key, 1);
          if (valid && (lane == 0 || k_prev != key)) {
            s_f[wp][0][i] -= sx;
            s_f[wp][1][i] -= sy;
            s_f[wp][2][i] -= sz;
          }
          if (REACT) {
            // j reaction: the first lane of each group of lanes with the
            // same j sums the group's forces in lane order
            s_p[wp][0][lane] = px;
            s_p[wp][1][lane] = py;
            s_p[wp][2][lane] = pz;
            const unsigned grp =
                __match_any_sync(FULL_MASK, valid ? jl : CHUNK + lane);
            __syncwarp();
            if (valid && (grp & lt_mask) == 0) {
              float ax = 0.f, ay = 0.f, az = 0.f;
              for (unsigned g = grp; g; g &= g - 1) {
                const int k = __ffs((int)g) - 1;
                ax += s_p[wp][0][k];
                ay += s_p[wp][1][k];
                az += s_p[wp][2][k];
              }
              s_fj[wp][0][jl] += ax;
              s_fj[wp][1][jl] += ay;
              s_fj[wp][2][jl] += az;
            }
          }
          __syncwarp();
        }
        if (REACT && hit) {                  // j reaction, once per chunk
          atomicAdd(&f_j[(size_t)gid * 3 + 0], s_fj[wp][0][lane]);
          atomicAdd(&f_j[(size_t)gid * 3 + 1], s_fj[wp][1][lane]);
          atomicAdd(&f_j[(size_t)gid * 3 + 2], s_fj[wp][2][lane]);
          s_fj[wp][0][lane] = 0.f;
          s_fj[wp][1][lane] = 0.f;
          s_fj[wp][2][lane] = 0.f;
        }
        __syncwarp();
      }                                       // chunk loop
    }
  }

  if (counts != nullptr && lane == 0 && n_pairs > 0)
    atomicAdd(counts, n_pairs);
  if (WANT_E) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      elj_acc += __shfl_xor_sync(FULL_MASK, elj_acc, o);
      ec_acc += __shfl_xor_sync(FULL_MASK, ec_acc, o);
    }
  }
  if (lane == 0) {
    s_e[wp][0] = elj_acc;
    s_e[wp][1] = ec_acc;
  }
  __syncthreads();
  // this block's partial, summed over its warps in warp order
  float* dst = part + ((size_t)p_idx * nc + c) * ROW_F;
  for (int k = t; k < ROW_F; k += THREADS) {
    const int i = k / 3, comp = k - 3 * i;
    float v = s_f[0][comp][i];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) v += s_f[w][comp][i];
    dst[k] = v;
  }
  if (t == 0) {
    float e0 = s_e[0][0], e1 = s_e[0][1];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) {
      e0 += s_e[w][0];
      e1 += s_e[w][1];
    }
    float* de = part + (size_t)gridDim.y * nc * ROW_F +
                ((size_t)p_idx * nc + c) * 2;
    de[0] = e0;
    de[1] = e1;
  }
}

// The part sum: f_i (+= where it holds the reactions, else =) and e, each
// the sum of the parts' partials in part order.
__global__ void __launch_bounds__(256)
colpair_part_sum(const float* __restrict__ part, int parts, int nc,
                 float* f_i, int accumulate, float* __restrict__ e,
                 float ehalf) {
  const size_t n_f = (size_t)nc * ROW_F;
  const size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n_f) {
    float v = part[k];
    for (int p = 1; p < parts; ++p) v += part[(size_t)p * n_f + k];
    f_i[k] = accumulate ? f_i[k] + v : v;
  } else if (k < n_f + 2 * (size_t)nc) {
    const size_t m = k - n_f;
    const float* pe = part + (size_t)parts * n_f;
    float v = pe[m];
    for (int p = 1; p < parts; ++p) v += pe[(size_t)p * 2 * nc + m];
    e[m] = ehalf * v;
  }
}

struct Args {
  int nc, parts, wl_w, S, i_base;
  const void *wl, *nw, *rows, *pT, *box, *prm, *cpl;
  void *f_j, *part, *counts;
  cudaStream_t st;
};

template <int MODE, bool WANT_E, bool WFILT, bool ALCH, int TABLE>
void launch(const Args& a) {
  colpair_kernel<MODE, WANT_E, WFILT, ALCH, TABLE>
      <<<dim3(a.nc, a.parts), THREADS, 0, a.st>>>(
          (const int*)a.wl, a.wl_w, (const int*)a.nw, (const float*)a.rows,
          (const float*)a.pT, a.S, (const float*)a.box, (const float*)a.prm,
          (const float*)a.cpl, a.i_base, (float*)a.f_j, (float*)a.part,
          (unsigned long long*)a.counts);
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

int launch_table(int table, int mode, int want_energy, int water_filter,
                 int alch, const Args& a) {
  if (table == TABLE_SYM) {
    if (mode != MODE_FULL || water_filter) return (int)cudaErrorInvalidValue;
    if (alch)
      launch_full<true, TABLE_SYM>(want_energy, a);
    else
      launch_full<false, TABLE_SYM>(want_energy, a);
    return 0;
  }
  if (table == TABLE_CROSS) {
    if (mode != MODE_FULL || water_filter || alch || a.i_base != 0)
      return (int)cudaErrorInvalidValue;
    launch_full<false, TABLE_CROSS>(want_energy, a);
    return 0;
  }
  if (table != TABLE_TRI) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case MODE_LJ:
      if (alch) return (int)cudaErrorInvalidValue;
      launch_flags<MODE_LJ, false>(want_energy, water_filter, a);
      return 0;
    case MODE_FULL:
      if (alch)
        launch_flags<MODE_FULL, true>(want_energy, water_filter, a);
      else
        launch_flags<MODE_FULL, false>(want_energy, water_filter, a);
      return 0;
    case MODE_COUL:
      if (alch)
        launch_flags<MODE_COUL, true>(want_energy, water_filter, a);
      else
        launch_flags<MODE_COUL, false>(want_energy, water_filter, a);
      return 0;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the pair kernel and the part sum on `stream`, allocates
// nothing, returns cudaGetLastError() (or cudaErrorInvalidValue for
// arguments it does not take). table: 0 triangular, 1 symmetric (mode full,
// no water filter), 2 cross (mode full, no water filter, no alch, i_base 0;
// the water group-id range in prm[4..5]). alch selects the has_alch
// instances (modes full and coul only; `cpl` points at the couple scalar
// and is not read otherwise). S is the j array's slot count, i_base the j
// slot of the first i row (the i rows of the cross table are a separate
// array); f_i and f_j may be the same buffer (then S == nc * 64 and
// i_base == 0). parts is the grid's parts per cluster, scratch holds
// parts * nc * 194 floats, counts is null or one int64.
extern "C" int colpair_launch(int table, int mode, int want_energy,
                              int water_filter, int alch, int nc, int parts,
                              int wl_w, int S, int i_base, const void* wl,
                              const void* nw, const void* rows,
                              const void* pT, const void* box,
                              const void* prm, const void* cpl, void* f_i,
                              void* f_j, void* e, void* scratch,
                              void* counts, void* stream) {
  const Args a{nc, parts, wl_w, S, i_base, wl, nw, rows, pT, box, prm, cpl,
               f_j, scratch, counts, (cudaStream_t)stream};
  if (nc <= 0) return (int)cudaGetLastError();
  if (parts < 1 || parts > 65535 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  if (i_base < 0 || (table != TABLE_CROSS && i_base + nc * ICL > S))
    return (int)cudaErrorInvalidValue;
  if (alch && cpl == nullptr) return (int)cudaErrorInvalidValue;
  const int bad = launch_table(table, mode, want_energy, water_filter, alch, a);
  if (bad) return bad;
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the triangular table outside the shard adds its i-forces to the
  // reactions in one buffer; the others store them
  const int accumulate = table == TABLE_TRI && f_i == f_j;
  const float ehalf = table == TABLE_SYM ? 0.5f : 1.f;
  const size_t n_out = (size_t)nc * (ROW_F + 2);
  colpair_part_sum<<<(unsigned)((n_out + 255) / 256), 256, 0,
                     (cudaStream_t)stream>>>(
      (const float*)scratch, parts, nc, (float*)f_i, accumulate, (float*)e,
      ehalf);
  return (int)cudaGetLastError();
}
