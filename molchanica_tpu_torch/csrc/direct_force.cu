// Cell-grid direct-space kernel: softcore LJ clipped at LJ_CLIP + Ewald
// Coulomb with the Abramowitz-Stegun 7.1.26 erfc, over a ghost-halo cell
// grid, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel molchanica_tpu/ops/pallas/direct_force.py::_kernel
// (built by make_pallas_direct_fn), the direct space of MdSim's pallas
// backend. The plain torch version of the same function is
// ops/direct_force.py::direct_force_plain, and the plain model of this
// kernel's schedule is ops/direct_force.py::direct_force_work; the layouts
// are described there and in ops/direct_force.py::DirectForce.
//
// What bounds it on an H100: the FP32 pair math. Per in-cutoff pair it
// spends ~85 FP32 operations (divides, sqrt, exp, the Horner erfc, the
// softcore LJ) against a few for every pair it tests, while the bytes it
// must move are the center rows, the ghost array and the output once each
// (~6.8 MB at the 25k-site config-3 grid: ~2 us at 3.35 TB/s). Each pair
// needs its own divides, square roots and exp of a distance, so the math is
// elementwise: neither wgmma nor the tensor cores apply. What sets the time
// beside the math: a cell's 27 neighbour cells hold 27 C slots, of which
// about 55% are empty at config 3, and of the real pairs only ~11% lie
// inside the cutoff.
//
// What the design does about it:
// - Work split. The grid is (cell, part), C / 32 parts per cell, each a
//   block of NWARP warps. A block ranks its cell's real sites in slot
//   order and cuts them into n_part = ceil(n_c / 32) even ranges; part q
//   takes range q and a part past n_part exits at once. So every SM holds
//   blocks of real sites, and no warp waits at a sync for lack of a site.
// - Compaction while staging. The block scans the 27 neighbour cells (9
//   slabs of 3 C contiguous ghost slots) and keeps a slot only if it holds
//   a real site whose squared distance to the bounding box of the part's
//   own sites is below rc^2 (1 + 1e-4), the box taken from their center
//   rows (so an atom a little outside [0, box) between rebuilds is
//   covered).
//   The kept ghost slots go to shared memory in scan order: each warp scans
//   a contiguous run of the positions, counts its keeps (ballot + popc),
//   and after one sync writes them at its offset.
// - Compaction of the pairs before the math. The kept slots are cut into
//   32-site j chunks, chunk k to warp k mod NWARP. A warp holds one j per
//   lane and tests it against the part's i sites (shared memory) with the
//   plain version's r^2 (no FMA contraction, so that every pair is decided
//   as there); the (i, j) pairs that pass go to a per-warp queue in shared
//   memory, in (i, j) order, by ballot + popc. When the queue could not
//   take another i, and after the chunk's last i, the pair math runs on
//   32-lane batches of the queue, the j data shuffled from the lane that
//   loaded it.
// - Reductions. Forces stay center-side: a batch's pair forces are summed
//   per i by a fixed-order segmented reduction over the lanes (the queue is
//   sorted by i), and the first lane of each i adds the sum to its warp's
//   shared partial; at the end the warps' partials are summed in warp
//   order and each i's row is written once, without atomics. The energies
//   are summed per lane in double, then over the lanes (a fixed xor tree),
//   the warps in order, and into the part's slot of the `scratch` partials;
//   a second kernel sums a cell's parts in part order and writes the half
//   sums. The output is the same bits on every launch.
// - Excluded and 1-4 pairs never enter: a queued pair is looked up in the
//   topology's exclusion table (ops/exclusions.py, one word load where the
//   two site indices lie within its reach W, none otherwise) as its lane
//   takes it for the math, so that the distance test stays a compare and a
//   ballot, and a set bit zeroes the pair's terms. The rest energy adds those
//   pairs' own terms (the Ewald exclusion correction, the scaled 1-4
//   terms), so nothing large is added here and taken out there: a bonded
//   pair at 1-1.5 A carries 1e4-1e5 kcal/mol/A of LJ force, which two
//   float32 evaluations of it from differently wrapped coordinates do not
//   cancel to better than a few kcal/mol/A.
//
// Layouts, per replica (every array has a leading replica axis of n_rep;
// the grid's z axis is the replica, so one launch runs n_rep independent
// grids of the same plan, the counterpart of vmap over the pallas_call):
//   center [n_cells C, 8] f32 rows: x, y, z (wrapped into [0, box)), q,
//          sigma, eps, couple mask, site index + 1 (0 = empty slot)
//   ghost  [8, G] f32 property-major, G = gx gy gz C, positions shifted by
//          whole boxes in the halo
//   params [2] f32: couple, beta
//   out    [n_cells C, 4] f32: forces in columns 0-2; column 3 holds the
//          cell's 0.5 sum(e_lj) in row 0, 0.5 sum(e_c) in row 1, else 0
//   scratch [n_cells * C / 32 * 2] f64: per-(cell, part) LJ and Coulomb sums
//   counts [1] i64 or null: when set, the kernel adds the number of pairs
//          that passed the cutoff, mask and exclusion tests (one atomic per
//          warp)
//   excl   [n_sites, words] u32, shared by the replicas: bit (d - 1) % 32
//          of word (d - 1) / 32 of row i set where sites i and i + d are an
//          excluded or 1-4 pair
#include <cuda_runtime.h>

namespace {

constexpr int MAX_CAP = 256;
constexpr int NWARP = 8;
constexpr int THREADS = NWARP * 32;
constexpr int PART_I = 32;                 // at most this many i per block
constexpr int QCAP = 512;                  // a warp's queue of (i, j lane)
constexpr int MAX_SCAN = 27 * MAX_CAP;     // neighbourhood slots
// the prefilter keeps j with squared distance to the box below rc^2 times
// this: far above the float32 roundoff of either distance
constexpr float BOX_MARGIN = 1.0001f;
constexpr float SOFTCORE_ALPHA = 0.5f;
constexpr float LJ_CLIP = 1.0e7f;
constexpr float COULOMB_CONST = 332.0637128f;
constexpr float TWO_OVER_SQRT_PI = 1.1283791670955126f;
constexpr float AS_P = 0.3275911f;
constexpr float AS_A0 = 0.254829592f;
constexpr float AS_A1 = -0.284496736f;
constexpr float AS_A2 = 1.421413741f;
constexpr float AS_A3 = -1.453152027f;
constexpr float AS_A4 = 1.061405429f;
constexpr unsigned FULL_MASK = 0xffffffffu;

// whether sites a and b are an excluded or 1-4 pair (ops/exclusions.py)
__device__ __forceinline__ bool excluded(const unsigned* __restrict__ excl,
                                         int words, int a, int b) {
  const int d = abs(a - b) - 1;
  const int lo = min(a, b);
  if (d < 0 || d >= 32 * words || lo < 0) return false;
  return (__ldg(excl + (size_t)lo * words + (d >> 5)) >> (d & 31)) & 1u;
}

// r^2 of the plain version, without FMA contraction
__device__ __forceinline__ float dist2_rn(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__global__ void __launch_bounds__(THREADS, 4)
direct_force_kernel(const float* __restrict__ center,
                    const float* __restrict__ ghost, int G,
                    const float* __restrict__ params, int cap, int ncy,
                    int ncz, int gy, int gz, float rc2,
                    float* __restrict__ out, double* __restrict__ e_part,
                    unsigned long long* __restrict__ counts,
                    const unsigned* __restrict__ excl, int excl_words) {
  __shared__ float4 s_pos[PART_I];               // x, y, z, q
  __shared__ float4 s_par[PART_I];               // sigma, eps, couple, -
  __shared__ int s_slot[PART_I];                 // the i's center slot
  __shared__ int s_site[PART_I];                 // the i's site index
  __shared__ int s_j[MAX_SCAN];                  // kept ghost slots
  __shared__ unsigned short s_q[NWARP][QCAP];    // (i << 5) | j lane
  __shared__ float s_f[NWARP][3][PART_I];        // per-warp i-forces
  __shared__ int s_start[9];                     // each slab's first slot
  __shared__ int s_cc[NWARP], s_jc[NWARP];
  __shared__ float s_bb[NWARP][6];
  __shared__ double s_e[NWARP][2];

  const int p = blockIdx.x;
  const int part = blockIdx.y;
  // replica blockIdx.z: its arrays follow the previous replica's
  {
    const size_t r = blockIdx.z;
    const size_t S = (size_t)gridDim.x * cap;
    center += r * S * 8;
    ghost += r * 8 * (size_t)G;
    params += r * 2;
    out += r * S * 4;
    e_part += r * (size_t)gridDim.x * gridDim.y * 2;
    if (counts != nullptr) counts += r;
  }
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int wp = t >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  double* ep = e_part + ((size_t)p * gridDim.y + part) * 2;

  // halo 1: slab (dx, dy) of the cell's neighbourhood is the 3 C ghost
  // slots from base_g + ((dx gy + dy) gz) C (ghost z-cells k..k+2)
  const int cell_i = p / (ncy * ncz);
  const int rem = p - cell_i * (ncy * ncz);
  const int cell_j = rem / ncz;
  const int cell_k = rem - cell_j * ncz;
  if (t < 9)
    s_start[t] = (((cell_i + t / 3) * gy + cell_j + t % 3) * gz + cell_k) * cap;

  // 1. the cell's real sites, ranked in slot order
  const float* c = center + ((size_t)p * cap + t) * 8;
  float cx = 0.f, cy = 0.f, cz = 0.f;
  bool c_ok = false;
  if (t < cap) {
    c_ok = c[7] > 0.5f;
    cx = c[0];
    cy = c[1];
    cz = c[2];
  }
  const unsigned cm = __ballot_sync(FULL_MASK, c_ok);
  if (lane == 0) s_cc[wp] = __popc(cm);
  if (part == 0 && t < cap && !c_ok)              // empty slots: zero rows
    *reinterpret_cast<float4*>(out + ((size_t)p * cap + t) * 4) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  int rank = __popc(cm & lt_mask), n_c = 0;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) {
    rank += w < wp ? s_cc[w] : 0;
    n_c += s_cc[w];
  }
  const int n_part = (n_c + PART_I - 1) / PART_I;
  if (part >= n_part) {                          // uniform over the block
    if (t < 2) ep[t] = 0.0;
    return;
  }
  const int i_lo = part * n_c / n_part;
  const int n_i = (part + 1) * n_c / n_part - i_lo;
  const bool mine = c_ok && rank >= i_lo && rank < i_lo + n_i;
  if (mine) {
    s_pos[rank - i_lo] = make_float4(cx, cy, cz, c[3]);
    s_par[rank - i_lo] = make_float4(c[4], c[5], c[6], 0.f);
    s_slot[rank - i_lo] = t;
    s_site[rank - i_lo] = (int)c[7] - 1;
  }
  // the bounding box of the part's sites
  float bb[6] = {mine ? cx : INFINITY,  mine ? cy : INFINITY,
                 mine ? cz : INFINITY,  mine ? cx : -INFINITY,
                 mine ? cy : -INFINITY, mine ? cz : -INFINITY};
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      bb[a] = fminf(bb[a], __shfl_xor_sync(FULL_MASK, bb[a], o));
      bb[a + 3] = fmaxf(bb[a + 3], __shfl_xor_sync(FULL_MASK, bb[a + 3], o));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 6; ++a) s_bb[wp][a] = bb[a];
  }
  for (int k = t; k < NWARP * 3 * PART_I; k += THREADS)
    (&s_f[0][0][0])[k] = 0.f;
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 6; ++a) bb[a] = s_bb[0][a];
#pragma unroll
  for (int w = 1; w < NWARP; ++w) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      bb[a] = fminf(bb[a], s_bb[w][a]);
      bb[a + 3] = fmaxf(bb[a + 3], s_bb[w][a + 3]);
    }
  }

  // 2. stage the neighbourhood: scan position u in [0, 27 C) is slot
  //    u mod 3 C of slab u / 3 C; each warp scans a run of `steps` 32-slot
  //    steps (3 C is a multiple of 32, so a step lies in one slab)
  const int L = 3 * cap;
  const int steps = (9 * L + THREADS - 1) / THREADS;   // <= 27
  const int s0 = wp * steps * 32 / L;
  const int o0 = wp * steps * 32 - s0 * L;
  const float rc2_box = __fmul_rn(rc2, BOX_MARGIN);
  const size_t Gs = (size_t)G;
  unsigned keep_bits = 0;
  int n_keep = 0;
  for (int st = 0, sl = s0, o = o0; st < steps; ++st) {
    bool keep = false;
    if (sl < 9) {
      const size_t g = (size_t)(s_start[sl] + o + lane);
      if (ghost[7 * Gs + g] > 0.5f) {
        const float x = ghost[g], y = ghost[Gs + g], z = ghost[2 * Gs + g];
        const float dx = fmaxf(fmaxf(__fsub_rn(bb[0], x), __fsub_rn(x, bb[3])),
                               0.f);
        const float dy = fmaxf(fmaxf(__fsub_rn(bb[1], y), __fsub_rn(y, bb[4])),
                               0.f);
        const float dz = fmaxf(fmaxf(__fsub_rn(bb[2], z), __fsub_rn(z, bb[5])),
                               0.f);
        keep = dist2_rn(dx, dy, dz) < rc2_box;
      }
    }
    keep_bits |= (unsigned)keep << st;
    n_keep += __popc(__ballot_sync(FULL_MASK, keep));
    o += 32;
    if (o == L) {
      o = 0;
      ++sl;
    }
  }
  if (lane == 0) s_jc[wp] = n_keep;
  __syncthreads();
  int off = 0, n_j = 0;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) {
    off += w < wp ? s_jc[w] : 0;
    n_j += s_jc[w];
  }
  for (int st = 0, sl = s0, o = o0; st < steps; ++st) {
    const bool keep = (keep_bits >> st) & 1u;
    const unsigned m = __ballot_sync(FULL_MASK, keep);
    if (keep) s_j[off + __popc(m & lt_mask)] = s_start[sl] + o + lane;
    off += __popc(m);
    o += 32;
    if (o == L) {
      o = 0;
      ++sl;
    }
  }
  __syncthreads();

  // 3. 32-site j chunks over the warps: test, queue, math on full batches
  const float couple = params[0];
  const float beta = params[1];
  const float c_ex = TWO_OVER_SQRT_PI * beta;
  unsigned short* q = s_q[wp];
  double elj = 0.0, ec = 0.0;   // a cell's sums of thousands of terms, as
                                // the plain version sums them
  unsigned long long n_pairs = 0;
  const int n_ch = (n_j + 31) / 32;
  for (int ch = wp; ch < n_ch; ch += NWARP) {
    const int jj = ch * 32 + lane;
    const bool in = jj < n_j;
    float jx = 0.f, jy = 0.f, jz = 0.f, jq = 0.f, js = 0.f, je = 0.f;
    float jc = 0.f;
    int jsite = -1;
    if (in) {
      const size_t g = (size_t)s_j[jj];
      jx = ghost[g];
      jy = ghost[Gs + g];
      jz = ghost[2 * Gs + g];
      jq = ghost[3 * Gs + g];
      js = ghost[4 * Gs + g];
      je = ghost[5 * Gs + g];
      jc = ghost[6 * Gs + g];
      jsite = (int)ghost[7 * Gs + g] - 1;
    }
    int cnt = 0;
    for (int ii = 0; ii < n_i; ++ii) {
      const float4 pi = s_pos[ii];
      const float r2 = dist2_rn(__fsub_rn(pi.x, jx), __fsub_rn(pi.y, jy),
                                __fsub_rn(pi.z, jz));
      const bool ok = in && r2 < rc2 && r2 > 1e-9f;
      const unsigned m = __ballot_sync(FULL_MASK, ok);
      if (ok) q[cnt + __popc(m & lt_mask)] = (unsigned short)((ii << 5) | lane);
      cnt += __popc(m);
      if (cnt <= QCAP - 32 && ii < n_i - 1) continue;   // uniform
      __syncwarp();
      for (int b = 0; b < cnt; b += 32) {
        const bool queued = b + lane < cnt;
        const int qe = queued ? (int)q[b + lane] : 0;
        const int i = qe >> 5;
        const int jl = qe & 31;
        const int ssite = __shfl_sync(FULL_MASK, jsite, jl);
        const bool valid =
            queued && !excluded(excl, excl_words, s_site[i], ssite);
        n_pairs += __popc(__ballot_sync(FULL_MASK, valid));
        const float sx = __shfl_sync(FULL_MASK, jx, jl);
        const float sy = __shfl_sync(FULL_MASK, jy, jl);
        const float sz = __shfl_sync(FULL_MASK, jz, jl);
        const float sq = __shfl_sync(FULL_MASK, jq, jl);
        const float ss = __shfl_sync(FULL_MASK, js, jl);
        const float se = __shfl_sync(FULL_MASK, je, jl);
        const float sc = __shfl_sync(FULL_MASK, jc, jl);
        float px = 0.f, py = 0.f, pz = 0.f;
        if (valid) {
          const float4 ci = s_pos[i];
          const float4 ai = s_par[i];
          const float cq = ci.w, cs = ai.x, ce = ai.y, cc = ai.z;
          const float dx = __fsub_rn(ci.x, sx);
          const float dy = __fsub_rn(ci.y, sy);
          const float dz = __fsub_rn(ci.z, sz);
          const float r2s = fmaxf(dist2_rn(dx, dy, dz), 1e-4f);
          const float inv_r2 = 1.0f / r2s;
          // softcore LJ
          const float sig = 0.5f * (cs + ss);
          const float eps4 = 4.0f * sqrtf(ce * se);
          const float is_alch = cc + sc - 2.0f * cc * sc;
          const float cpl = 1.0f - is_alch * (1.0f - couple);
          const float a_sc = SOFTCORE_ALPHA * (1.0f - cpl);
          const float s2 = sig * sig * inv_r2;
          const float s6 = s2 * s2 * s2;
          const float inv_den = 1.0f / (a_sc * s6 + 1.0f);
          const float lj_inv = s6 * inv_den;
          const float lj_pre = eps4 * cpl;
          const float e_lj_raw = lj_pre * (lj_inv * lj_inv - lj_inv);
          float dlj = 0.f;
          if (fabsf(e_lj_raw) < LJ_CLIP)
            dlj = lj_pre * (2.0f * lj_inv - 1.0f) * (inv_den * inv_den) *
                  (-3.0f * s6 * inv_r2);
          elj += (double)fminf(fmaxf(e_lj_raw, -LJ_CLIP), LJ_CLIP);
          // Ewald direct Coulomb
          const float r = sqrtf(r2s);
          const float inv_r = 1.0f / r;
          const float x = beta * r;
          const float tt = 1.0f / (1.0f + AS_P * x);
          const float poly =
              tt * (AS_A0 + tt * (AS_A1 + tt * (AS_A2 + tt * (AS_A3 +
                                                              tt * AS_A4))));
          const float ex = expf(-x * x);
          const float erfc_v = poly * ex;
          const float kqq = COULOMB_CONST * cq * sq * cpl;
          ec += (double)(kqq * erfc_v * inv_r);
          const float dc = -0.5f * kqq * inv_r2 * (erfc_v * inv_r + c_ex * ex);
          const float coeff = dlj + dc;
          px = coeff * dx;
          py = coeff * dy;
          pz = coeff * dz;
        }
        // the i-force: a segmented sum over the lanes of each i (a spent
        // lane is a segment of its own; an excluded pair adds zeros) in a
        // fixed order, then one add to the warp's partial by the segment's
        // first lane
        const int key = queued ? i : PART_I + lane;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int ko = __shfl_down_sync(FULL_MASK, key, o);
          const float ax = __shfl_down_sync(FULL_MASK, px, o);
          const float ay = __shfl_down_sync(FULL_MASK, py, o);
          const float az = __shfl_down_sync(FULL_MASK, pz, o);
          if (lane + o < 32 && ko == key) {
            px += ax;
            py += ay;
            pz += az;
          }
        }
        const int k_prev = __shfl_up_sync(FULL_MASK, key, 1);
        if (queued && (lane == 0 || k_prev != key)) {
          s_f[wp][0][i] += px;
          s_f[wp][1][i] += py;
          s_f[wp][2][i] += pz;
        }
        __syncwarp();
      }
      cnt = 0;
    }
  }

  // 4. forces (warps summed in order) and the part's energies
  if (counts != nullptr && lane == 0 && n_pairs > 0)
    atomicAdd(counts, n_pairs);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    elj += __shfl_xor_sync(FULL_MASK, elj, o);
    ec += __shfl_xor_sync(FULL_MASK, ec, o);
  }
  if (lane == 0) {
    s_e[wp][0] = elj;
    s_e[wp][1] = ec;
  }
  __syncthreads();
  if (t < n_i) {
    float fx = s_f[0][0][t], fy = s_f[0][1][t], fz = s_f[0][2][t];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) {
      fx += s_f[w][0][t];
      fy += s_f[w][1][t];
      fz += s_f[w][2][t];
    }
    *reinterpret_cast<float4*>(out + ((size_t)p * cap + s_slot[t]) * 4) =
        make_float4(-2.f * fx, -2.f * fy, -2.f * fz, 0.f);
  }
  if (t < 2) {
    double acc = s_e[0][t];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) acc += s_e[w][t];
    ep[t] = acc;
  }
}

// A cell's half-summed energies: its parts' sums in part order, into
// column 3 of the cell's rows 0 (LJ) and 1 (Coulomb); the cells of every
// replica, one after the other.
__global__ void __launch_bounds__(256)
direct_force_energy(const double* __restrict__ e_part, int n_cells,
                    int n_rep, int parts, int cap, float* __restrict__ out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= 2 * n_cells * n_rep) return;
  const int p = m >> 1, term = m & 1;
  const double* e = e_part + (size_t)p * parts * 2 + term;
  double acc = e[0];
  for (int k = 1; k < parts; ++k) acc += e[2 * k];
  out[((size_t)p * cap + term) * 4 + 3] = (float)(0.5 * acc);
}

}  // namespace

// Launches the pair kernel and the energy sum on `stream` for n_rep
// replicas of one grid (a leading replica axis on center, ghost, params,
// out, scratch and counts; the grid's z axis), allocates nothing, returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments it does not
// take). scratch holds n_rep * n_cells * cap / 32 * 2 doubles; counts is
// null or n_rep int64; excl is the exclusion table of excl_words words a
// site, which every replica reads.
extern "C" int direct_force_launch(int n_rep, int n_cells, int cap, int ncy,
                                   int ncz, int gy, int gz, int G, float rc2,
                                   const void* center, const void* ghost,
                                   const void* params, void* out,
                                   void* scratch, void* counts,
                                   const void* excl, int excl_words,
                                   void* stream) {
  if (cap <= 0 || cap % PART_I != 0 || cap > MAX_CAP || scratch == nullptr
      || n_rep <= 0 || n_rep > 65535 || excl == nullptr || excl_words <= 0)
    return (int)cudaErrorInvalidValue;
  if (n_cells <= 0) return (int)cudaGetLastError();
  const int parts = cap / PART_I;
  direct_force_kernel<<<dim3(n_cells, parts, n_rep), THREADS, 0,
                        (cudaStream_t)stream>>>(
      (const float*)center, (const float*)ghost, G, (const float*)params,
      cap, ncy, ncz, gy, gz, rc2, (float*)out, (double*)scratch,
      (unsigned long long*)counts, (const unsigned*)excl, excl_words);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  direct_force_energy<<<(2 * n_cells * n_rep + 255) / 256, 256, 0,
                        (cudaStream_t)stream>>>(
      (const double*)scratch, n_cells, n_rep, parts, cap, (float*)out);
  return (int)cudaGetLastError();
}
