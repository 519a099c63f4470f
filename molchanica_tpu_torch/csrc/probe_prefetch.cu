// Block-pair accumulation probe, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/probe_prefetch.py::kernel: a grid of
// (cluster, window entry) with a scalar-prefetched slice list `sl` driving
// the j block, a per-cluster output block revisited over the entries, and
// a whole-array [8, S] accumulator updated at dynamic offsets. For cluster
// c and w < min(nw[c], W), s = sl[c, w]:
//   o[c's 64 rows, 0]   += sum over the 128 slots j of slice s of
//                          (rows[i, 0] - pT[0, j])^2
//   o2[0, slice s]      += sum over the 64 rows i of the same
// o is zero elsewhere (its columns 1-7, and the rows of a cluster with no
// entry); o2 rows 1-7 stay as the caller zeroed them. The plain torch
// version is ops/probe_prefetch.py::probe_plain.
//
// What bounds it on an H100: neither resource at the probe's shapes. Per
// (i, j) pair it spends 4 FP32 operations against 4 bytes per j slot and
// slice and 32 per row, a few hundred KB and a few MFLOP a call, so a
// launch is a few microseconds of work and its time is mostly the launch.
// What its design does about that: one block per cluster of NWARP warps,
// and a cluster's entries dealt to the warps in rounds, entry e0 + w to
// warp w, so the entries of a round run side by side. A warp covers its
// entry's 64 x 128 pair tile as a 4 x 8 grid of lanes, each lane a 16 x 16
// register tile: it keeps its 16 row sums and 16 column sums in registers
// (no shuffles), then the lanes' partials meet in shared memory, where each
// row sum is added over the 8 column groups and each column sum over the 4
// row groups, both in a fixed order. A cluster's row sums are then added
// entry by entry in entry order, so o is deterministic. Repeated slices
// (in one cluster's list or across clusters) hit the same o2 slots, so o2
// is accumulated with float atomics and its summation order changes from
// run to run at float32 roundoff.
//
// Layouts (see ops/probe_prefetch.py):
//   nw   [NC] i32 entries per cluster (clamped to [0, W])
//   sl   [NC, W] i32 slice per entry, in [0, S / 128); an entry outside it
//        is skipped
//   rows [NC*64, 8] f32 (only column 0 is read)
//   pT   [8, S] f32 (only row 0 is read)
//   o    [NC*64, 8] f32 out, every element written
//   o2   [8, S] f32 out, zeroed by the caller
#include <cuda_runtime.h>

namespace {

constexpr int ICL = 64;
constexpr int LANES = 128;
constexpr int NWARP = 8;                // entries of a round, one a warp
constexpr int THREADS = NWARP * 32;
constexpr int RG = 4;                   // a warp's lanes: RG row groups
constexpr int CG = 8;                   // x CG column groups
constexpr int TR = ICL / RG;            // rows of a lane's tile
constexpr int TC = LANES / CG;          // columns of a lane's tile

__global__ void __launch_bounds__(THREADS)
probe_kernel(const int* __restrict__ nw, const int* __restrict__ sl, int W,
             const float* __restrict__ rows, const float* __restrict__ pT,
             int S, float* __restrict__ o, float* __restrict__ o2) {
  __shared__ float s_x[ICL];
  __shared__ float s_row[NWARP][CG][ICL];     // row partials per column group
  __shared__ float s_col[NWARP][RG][LANES];   // column partials per row group
  __shared__ float s_o[NWARP][ICL];           // each warp's entry row sums

  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int wp = t >> 5;
  const int rg = lane / CG;                   // rows rg + RG m
  const int cg = lane % CG;                   // columns cg + CG k
  if (t < ICL) s_x[t] = rows[(size_t)(c * ICL + t) * 8];
  __syncthreads();
  float xi[TR];
#pragma unroll
  for (int m = 0; m < TR; ++m) xi[m] = s_x[rg + RG * m];

  const int n = min(max(nw[c], 0), W);
  const int n_sl = S / LANES;
  float acc = 0.f;                            // row t's sum (t < ICL)
  for (int e0 = 0; e0 < n; e0 += NWARP) {     // uniform over the block
    const int e = e0 + wp;
    const int s = e < n ? sl[(size_t)c * W + e] : -1;
    if (s >= 0 && s < n_sl) {                 // uniform over the warp
      float xj[TC];
#pragma unroll
      for (int k = 0; k < TC; ++k) xj[k] = pT[(size_t)s * LANES + cg + CG * k];
      float rs[TR], cs[TC];
#pragma unroll
      for (int m = 0; m < TR; ++m) rs[m] = 0.f;
#pragma unroll
      for (int k = 0; k < TC; ++k) cs[k] = 0.f;
#pragma unroll
      for (int m = 0; m < TR; ++m) {
#pragma unroll
        for (int k = 0; k < TC; ++k) {
          const float d = xi[m] - xj[k];
          const float v = d * d;
          rs[m] += v;
          cs[k] += v;
        }
      }
#pragma unroll
      for (int m = 0; m < TR; ++m) s_row[wp][cg][rg + RG * m] = rs[m];
#pragma unroll
      for (int k = 0; k < TC; ++k) s_col[wp][rg][cg + CG * k] = cs[k];
      __syncwarp();
      for (int r = lane; r < ICL; r += 32) {
        float v = s_row[wp][0][r];
#pragma unroll
        for (int g = 1; g < CG; ++g) v += s_row[wp][g][r];
        s_o[wp][r] = v;
      }
      for (int j = lane; j < LANES; j += 32) {
        float v = s_col[wp][0][j];
#pragma unroll
        for (int g = 1; g < RG; ++g) v += s_col[wp][g][j];
        atomicAdd(&o2[(size_t)s * LANES + j], v);    // o2 row 0
      }
    } else {
      for (int r = lane; r < ICL; r += 32) s_o[wp][r] = 0.f;
    }
    __syncthreads();
    if (t < ICL) {
#pragma unroll
      for (int w = 0; w < NWARP; ++w) acc += s_o[w][t];   // entry order
    }
    __syncthreads();
  }
  if (t < ICL) s_x[t] = acc;
  __syncthreads();
  for (int k = t; k < ICL * 8; k += THREADS)
    o[(size_t)c * ICL * 8 + k] = (k & 7) == 0 ? s_x[k >> 3] : 0.f;
}

}  // namespace

// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int probe_launch(int nc, int W, int S, const void* nw,
                            const void* sl, const void* rows, const void* pT,
                            void* o, void* o2, void* stream) {
  if (nc <= 0) return (int)cudaGetLastError();
  if (W < 0 || S <= 0 || S % LANES) return (int)cudaErrorInvalidValue;
  probe_kernel<<<nc, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)nw, (const int*)sl, W, (const float*)rows,
      (const float*)pT, S, (float*)o, (float*)o2);
  return (int)cudaGetLastError();
}
