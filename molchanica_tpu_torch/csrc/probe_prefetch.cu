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
// launch is a microsecond of work and its time is the launch itself.
// What its design does about that: the simplest kernel that is right. One
// block per cluster and one thread per lane of a slice: each thread reads
// its j slot once per entry (coalesced) and keeps the column sum in a
// register; row sums are warp reductions into a per-warp partial in shared
// memory, summed in warp order, so o is deterministic. Repeated slices (in
// one cluster's list or across clusters) hit the same o2 slots, so o2 is
// accumulated with float atomics and its summation order changes from run
// to run at float32 roundoff.
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
constexpr int NWARP = LANES / 32;
constexpr unsigned FULL_MASK = 0xffffffffu;

__global__ void __launch_bounds__(LANES)
probe_kernel(const int* __restrict__ nw, const int* __restrict__ sl, int W,
             const float* __restrict__ rows, const float* __restrict__ pT,
             int S, float* __restrict__ o, float* __restrict__ o2) {
  __shared__ float s_x[ICL];
  __shared__ float s_o[NWARP][ICL];   // per-warp partial row sums

  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int wp = t >> 5;
  if (t < ICL) s_x[t] = rows[(size_t)(c * ICL + t) * 8];
  for (int k = t; k < NWARP * ICL; k += LANES) (&s_o[0][0])[k] = 0.f;
  __syncthreads();

  const int n = min(max(nw[c], 0), W);
  const int n_sl = S / LANES;
  for (int w = 0; w < n; ++w) {
    const int s = sl[(size_t)c * W + w];
    if (s < 0 || s >= n_sl) continue;              // uniform over the block
    const int gid = s * LANES + t;
    const float jx = pT[gid];
    float col = 0.f;
    for (int i = 0; i < ICL; ++i) {
      const float d = s_x[i] - jx;
      const float v = d * d;
      col += v;
      float r = v;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        r += __shfl_xor_sync(FULL_MASK, r, off);
      if (lane == 0) s_o[wp][i] += r;
    }
    atomicAdd(&o2[gid], col);                      // o2 row 0
  }
  __syncthreads();
  for (int k = t; k < ICL * 8; k += LANES) {
    const int i = k >> 3, comp = k & 7;
    float v = 0.f;
    if (comp == 0) {
      v = s_o[0][i];
#pragma unroll
      for (int w = 1; w < NWARP; ++w) v += s_o[w][i];
    }
    o[(size_t)c * ICL * 8 + k] = v;
  }
}

}  // namespace

// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int probe_launch(int nc, int W, int S, const void* nw,
                            const void* sl, const void* rows, const void* pT,
                            void* o, void* o2, void* stream) {
  if (nc <= 0) return (int)cudaGetLastError();
  if (W < 0 || S <= 0 || S % LANES) return (int)cudaErrorInvalidValue;
  probe_kernel<<<nc, LANES, 0, (cudaStream_t)stream>>>(
      (const int*)nw, (const int*)sl, W, (const float*)rows,
      (const float*)pT, S, (float*)o, (float*)o2);
  return (int)cudaGetLastError();
}
