// Cell-grid direct-space kernel: softcore LJ clipped at LJ_CLIP + Ewald
// Coulomb with the Abramowitz-Stegun 7.1.26 erfc, over a ghost-halo cell
// grid, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel molchanica_tpu/ops/pallas/direct_force.py::_kernel
// (built by make_pallas_direct_fn), the direct space of MdSim's pallas
// backend. The plain torch version of the same function is
// ops/direct_force.py::direct_force_plain; the layouts are described there
// and in ops/direct_force.py::DirectForce.
//
// What it computes: one block per interior cell (n_cells blocks), one
// thread per center slot (blockDim = C, the cell capacity). The block walks
// the cell's 9 slabs, each 3 C contiguous ghost slots (3 consecutive ghost
// z-cells); each slab is staged through shared memory (8 properties x 3 C
// floats, 24 KB at C = 256) with coalesced loads from the property-major
// ghost array, and every thread evaluates its center against all 3 C slab
// slots. Forces are center-side only (each pair is evaluated from both of
// its cells), summed in registers and written without atomics; the cell's
// two energies are summed in double and reduced in a fixed order (warp
// shuffles, then the warps in order), and written half-summed as float32
// into column 3, rows 0 and 1. The result is the same from run to run.
//
// What bounds it on an H100: the FP32 pair math. Per in-cutoff pair it
// spends ~85 FP32 operations (divides, sqrt, exp, the Horner erfc, the
// softcore LJ) against ~10 for every pair slot it tests, while the bytes it
// must move are the center rows, the ghost array and the output once each
// (~6.8 MB at the 25k-site config-3 grid: ~2 us at 3.35 TB/s). Only ~2.3%
// of the 382 M pair slots of a launch lie inside the cutoff, so the bound
// counts the in-cutoff pairs times their operations against 67 TFLOP/s
// (~11 us at config 3).
// What the design does about it: little yet. It tests every slot (the
// 97.7% outside the cutoff cost the distance test and a divergent branch),
// and 216 blocks on 132 SMs leave some SMs with twice the cells of others.
// Skipping out-of-range slots, wgmma and TMA are later work.
//
// Layouts:
//   center [n_cells C, 8] f32 rows: x, y, z (wrapped into [0, box)), q,
//          sigma, eps, couple mask, valid (0 = empty slot)
//   ghost  [8, G] f32 property-major, G = gx gy gz C, positions shifted by
//          whole boxes in the halo
//   params [2] f32: couple, beta
//   out    [n_cells C, 4] f32: forces in columns 0-2; column 3 holds the
//          cell's 0.5 sum(e_lj) in row 0, 0.5 sum(e_c) in row 1, else 0
#include <cuda_runtime.h>

namespace {

constexpr int MAX_CAP = 256;
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

__global__ void __launch_bounds__(MAX_CAP)
direct_force_kernel(const float* __restrict__ center,
                    const float* __restrict__ ghost, int G,
                    const float* __restrict__ params, int ncy, int ncz,
                    int gy, int gz, float rc2, float* __restrict__ out) {
  extern __shared__ float sm[];                 // [8][3 C]
  __shared__ double s_red[2][MAX_CAP / 32];
  const int cap = blockDim.x;
  const int L = 3 * cap;
  const int p = blockIdx.x;
  const int t = threadIdx.x;
  const int i = p / (ncy * ncz);
  const int rem = p - i * (ncy * ncz);
  const int j = rem / ncz;
  const int k = rem - j * ncz;
  // halo 1; the slab's z range starts at ghost z-cell k (interior k - 1)
  const size_t base_g = ((size_t)((i + 1) * gy + (j + 1)) * gz + k) * cap;
  const float couple = params[0];
  const float beta = params[1];
  const float c_ex = TWO_OVER_SQRT_PI * beta;

  const float* c = center + ((size_t)p * cap + t) * 8;
  const float cx = c[0], cy = c[1], cz = c[2], cq = c[3];
  const float cs = c[4], ce = c[5], cc = c[6];
  const bool c_ok = c[7] > 0.5f;
  float ax = 0.f, ay = 0.f, az = 0.f;
  // energies in double: a cell's sums mix excluded solute pairs of up to
  // LJ_CLIP with thousands of small terms, and float32 running sums lose
  // ~1e-5 of them (the forces do not: each slot sums its own pairs)
  double elj = 0.0, ec = 0.0;

  for (int s = 0; s < 9; ++s) {
    const int sdx = s / 3 - 1, sdy = s % 3 - 1;
    const size_t start =
        base_g + (size_t)((long long)((sdx * gy + sdy) * gz) * cap);
    __syncthreads();                            // previous slab consumed
    for (int q = t; q < 8 * L; q += cap) {
      const int prop = q / L;
      sm[q] = ghost[(size_t)prop * G + start + (q - prop * L)];
    }
    __syncthreads();
    if (!c_ok) continue;
    for (int l = 0; l < L; ++l) {
      // the distance test without FMA contraction, so that it decides
      // every pair exactly as the plain torch version does
      const float dx = __fsub_rn(cx, sm[l]);
      const float dy = __fsub_rn(cy, sm[L + l]);
      const float dz = __fsub_rn(cz, sm[2 * L + l]);
      const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (!(r2 < rc2 && r2 > 1e-9f && sm[7 * L + l] > 0.5f)) continue;
      const float sq = sm[3 * L + l], ss = sm[4 * L + l];
      const float se = sm[5 * L + l], sc = sm[6 * L + l];
      const float r2s = fmaxf(r2, 1e-4f);
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
      ax += coeff * dx;
      ay += coeff * dy;
      az += coeff * dz;
    }
  }

  float* o = out + ((size_t)p * cap + t) * 4;
  o[0] = -2.f * ax;
  o[1] = -2.f * ay;
  o[2] = -2.f * az;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    elj += __shfl_xor_sync(FULL_MASK, elj, off);
    ec += __shfl_xor_sync(FULL_MASK, ec, off);
  }
  if ((t & 31) == 0) {
    s_red[0][t >> 5] = elj;
    s_red[1][t >> 5] = ec;
  }
  __syncthreads();
  float e_half = 0.f;
  if (t < 2) {
    double acc = 0.0;
    for (int w = 0; w < (cap >> 5); ++w) acc += s_red[t][w];
    e_half = (float)(0.5 * acc);
  }
  o[3] = e_half;
}

}  // namespace

// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int direct_force_launch(int n_cells, int cap, int ncy, int ncz,
                                   int gy, int gz, int G, float rc2,
                                   const void* center, const void* ghost,
                                   const void* params, void* out,
                                   void* stream) {
  if (cap <= 0 || cap % 32 != 0 || cap > MAX_CAP)
    return (int)cudaErrorInvalidValue;
  if (n_cells <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)8 * 3 * cap * sizeof(float);
  direct_force_kernel<<<n_cells, cap, smem, (cudaStream_t)stream>>>(
      (const float*)center, (const float*)ghost, G, (const float*)params,
      ncy, ncz, gy, gz, rc2, (float*)out);
  return (int)cudaGetLastError();
}
