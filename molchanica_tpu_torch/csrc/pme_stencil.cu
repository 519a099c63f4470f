// SPME's order-6 B-spline stencil on the mesh: the charge spread and the
// force gather, for NVIDIA Hopper (sm_90a), in float32 and float64, every
// replica in one launch.
//
// Replaces no TPU kernel: the JAX package spreads and gathers with dense
// [N, K] and [N, Ky Kz] matrix products in XLA
// (molchanica_tpu/ops/pme3.py). The plain torch version of the same
// functions is ops/pme3.py's Pme3._spread_plain / _gather_plain, which
// form those dense products: at config 3's 60^3 mesh a [N, 3,600] panel of
// 361 MB a replica, of which each atom fills 36 columns, and ~10.8 GFLOP
// per product where the stencil needs 216 points an atom.
//
// What bounds it on an H100: the mesh traffic, not the arithmetic. The
// least work is ~8 FP32 operations per stencil point of each charged site
// (benchmark/counts.py::pme_ops): ~0.43 GFLOP for 13 config-3 replicas
// (251,290 charged sites), 0.007 ms at 67 TFLOP/s, and the mesh once
// written and once read (11.2 MB for 13 replicas at 60^3) ~0.007 ms at
// 3.35 TB/s. But the spread is ~54 M scattered adds into the mesh and the
// gather as many loads of it: the meshes of 13 replicas fit the 50 MB L2,
// so both run at L2's rate for atomics and loads.
//
// What the design does about it:
// - Six lanes per atom, one per z offset c of the stencil, five atoms to a
//   warp (lanes 30 and 31 idle). Each lane computes the atom's 18 weights
//   (and, in the gather, their 18 derivatives) in registers with the
//   Cox-de Boor recursion of ops/pme3.py::bspline_weights_and_derivs, in
//   the input's type, and walks the 36 (x, y) points of its z offset. The
//   six lanes of an atom touch six neighbouring mesh words at each step
//   (two or three 32-byte sectors of the integer mesh, one or two of phi),
//   so that a warp's access covers ~5-15 sectors, not 30.
// - The spread adds q wx wy wz (formed in T) with atomicAdd whose result
//   is unused (RED), skipping sites of zero charge, as 64-bit fixed point
//   in units of 2^-46 e, into an integer mesh that the caller zeroes; a
//   second kernel converts it to T. Integer adds commute, so the mesh is
//   the same bits whatever order the atomics land in, and a run restarted
//   from a checkpoint repeats bit for bit; float atomics would part two
//   such runs by ~1e-4 A in 20 steps. Each term is rounded by at most
//   2^-47 e (7e-15 e): far below float32's rounding of Q, and within
//   ~100 float64 roundings of mesh values of ~0.01-1 e. The sums must stay
//   below 2^17 e at every mesh point (Q is at most the sum of |q| over the
//   sites whose stencil covers the point).
// - The gather sums (dwx wy wz, wx dwy wz, wx wy dwz) phi and wx wy wz phi
//   in a fixed loop order, then over the atom's six lanes by shuffles in
//   lane order, without atomics: the same bits on every launch. One lane
//   writes dE/dx = q K / box times the sums and dE/dq.
// - The index convention is ops/pme3.py::_axis_weights': weight
//   M6(t + k) at mesh index (floor(u) - k) mod K, u = x / box K, for any
//   image of x.
//
// Layouts (leading replica axis of n_rep on all but box):
//   x [n, 3] T, q [n] T, box [3] T (shared), acc [kx, ky, kz] int64 (the
//   spread's scratch), mesh and phi [kx, ky, kz] T, gx [n, 3] T, gq [n] T.
#include <cuda_runtime.h>

namespace {

constexpr int P = 6;                  // spline order
constexpr int APW = 32 / P;           // atoms per warp
constexpr int NWARP = 4;
constexpr int THREADS = NWARP * 32;
constexpr int APB = APW * NWARP;      // atoms per block
constexpr int CONVERT_THREADS = 256;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr double FIX_SCALE = 70368744177664.0;     // 2^46 per e
constexpr double FIX_UNIT = 1.0 / FIX_SCALE;

// M6(t + k) and dM6(t + k)/dt for k = 0..5, as
// bspline_weights_and_derivs: M2(u) = max(1 - |u - 1|, 0), then
// M_n(u) = (u M_{n-1}(u) + (n - u) M_{n-1}(u - 1)) / (n - 1),
// dM_n(u) = M_{n-1}(u) - M_{n-1}(u - 1).
template <typename T, bool DERIV>
__device__ __forceinline__ void bspline(T t, T* w, T* dw) {
  T M[P], u[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    u[k] = t + T(k);
    M[k] = fmax(T(1) - fabs(u[k] - T(1)), T(0));
  }
#pragma unroll
  for (int n = 3; n <= P; ++n) {
    T Mnew[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const T m1 = k ? M[k - 1] : T(0);
      Mnew[k] = (u[k] * M[k] + (T(n) - u[k]) * m1) / T(n - 1);
      if (DERIV && n == P) dw[k] = M[k] - m1;
    }
#pragma unroll
    for (int k = 0; k < P; ++k) M[k] = Mnew[k];
  }
#pragma unroll
  for (int k = 0; k < P; ++k) w[k] = M[k];
}

// One atom's stencil on one axis: its weights (and derivatives) and
// floor(u) mod K.
template <typename T, bool DERIV>
__device__ __forceinline__ int axis(T xd, T boxd, int K, T* w, T* dw) {
  const T u = xd / boxd * T(K);
  const T u0 = floor(u);
  bspline<T, DERIV>(u - u0, w, dw);
  const int b = (int)u0 % K;          // no overflow for any int
  return b < 0 ? b + K : b;
}

__device__ __forceinline__ int wrap(int i, int K) {
  return i < 0 ? i + K : i;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
pme_spread_kernel(int n, int kx, int ky, int kz, const T* __restrict__ x,
                  const T* __restrict__ q, const T* __restrict__ box,
                  unsigned long long* __restrict__ acc) {
  const int lane = threadIdx.x & 31, slot = lane / P, c = lane - slot * P;
  const int i = blockIdx.x * APB + (threadIdx.x >> 5) * APW + slot;
  if (slot >= APW || i >= n) return;
  const size_t r = blockIdx.y;
  const T qi = q[r * n + i];
  if (qi == T(0)) return;
  const T* xi = x + (r * n + i) * 3;
  T wx[P], wy[P], wz[P];
  const int bx = axis<T, false>(xi[0], box[0], kx, wx, nullptr);
  const int by = axis<T, false>(xi[1], box[1], ky, wy, nullptr);
  const int bz = axis<T, false>(xi[2], box[2], kz, wz, nullptr);
  unsigned long long* m = acc + r * kx * ky * kz + wrap(bz - c, kz);
  const T wzc = wz[c];
#pragma unroll
  for (int a = 0; a < P; ++a) {
    const T qwx = qi * wx[a];
    unsigned long long* row = m + (size_t)wrap(bx - a, kx) * ky * kz;
#pragma unroll
    for (int b = 0; b < P; ++b) {
      const double v = (double)(qwx * (wy[b] * wzc)) * FIX_SCALE;
      atomicAdd(row + wrap(by - b, ky) * kz,
                (unsigned long long)__double2ll_rn(v));
    }
  }
}

// The fixed-point mesh in T.
template <typename T>
__global__ void __launch_bounds__(CONVERT_THREADS)
pme_convert_kernel(size_t size, const unsigned long long* __restrict__ acc,
                   T* __restrict__ mesh) {
  for (size_t i = blockIdx.x * (size_t)CONVERT_THREADS + threadIdx.x;
       i < size; i += (size_t)gridDim.x * CONVERT_THREADS)
    mesh[i] = (T)((double)(long long)acc[i] * FIX_UNIT);
}

// v summed over the six lanes of this lane's atom, in lane order (every
// lane of the warp takes part).
template <typename T>
__device__ __forceinline__ T atom_sum(T v, int first) {
  T s = __shfl_sync(FULL_MASK, v, first);
#pragma unroll
  for (int j = 1; j < P; ++j) s += __shfl_sync(FULL_MASK, v, first + j);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
pme_gather_kernel(int n, int kx, int ky, int kz, const T* __restrict__ x,
                  const T* __restrict__ q, const T* __restrict__ box,
                  const T* __restrict__ phi, T* __restrict__ gx,
                  T* __restrict__ gq) {
  const int lane = threadIdx.x & 31, slot = lane / P, c = lane - slot * P;
  const int i = blockIdx.x * APB + (threadIdx.x >> 5) * APW + slot;
  const bool live = slot < APW && i < n;
  const size_t r = blockIdx.y;
  T sx = T(0), sy = T(0), sz = T(0), s0 = T(0);
  if (live) {
    const T* xi = x + (r * n + i) * 3;
    T wx[P], wy[P], wz[P], dwx[P], dwy[P], dwz[P];
    const int bx = axis<T, true>(xi[0], box[0], kx, wx, dwx);
    const int by = axis<T, true>(xi[1], box[1], ky, wy, dwy);
    const int bz = axis<T, true>(xi[2], box[2], kz, wz, dwz);
    const T* m = phi + r * kx * ky * kz + wrap(bz - c, kz);
    T ax = T(0), ay = T(0), a0 = T(0);
#pragma unroll
    for (int a = 0; a < P; ++a) {
      const T* row = m + (size_t)wrap(bx - a, kx) * ky * kz;
      T pw = T(0), pd = T(0);      // sums over b of wy phi, dwy phi
#pragma unroll
      for (int b = 0; b < P; ++b) {
        const T p = row[wrap(by - b, ky) * kz];
        pw += wy[b] * p;
        pd += dwy[b] * p;
      }
      ax += dwx[a] * pw;
      ay += wx[a] * pd;
      a0 += wx[a] * pw;
    }
    sx = ax * wz[c];
    sy = ay * wz[c];
    sz = a0 * dwz[c];
    s0 = a0 * wz[c];
  }
  const int first = (lane < APW * P ? slot : 0) * P;
  sx = atom_sum(sx, first);
  sy = atom_sum(sy, first);
  sz = atom_sum(sz, first);
  s0 = atom_sum(s0, first);
  if (live && c == 0) {
    const T qi = q[r * n + i];
    T* g = gx + (r * n + i) * 3;
    g[0] = qi * sx * (T(kx) / box[0]);
    g[1] = qi * sy * (T(ky) / box[1]);
    g[2] = qi * sz * (T(kz) / box[2]);
    gq[r * n + i] = s0;
  }
}

bool bad(int n_rep, int n, int kx, int ky, int kz) {
  return n_rep <= 0 || n_rep > 65535 || n < 0 || kx < P || ky < P
      || kz < P || (long long)kx * ky * kz > (1LL << 31) - 1;
}

}  // namespace

// Each launches on `stream` for n_rep replicas of n sites on one
// kx x ky x kz mesh (float64 when dtype64, else float32), allocates
// nothing and returns cudaGetLastError() (or cudaErrorInvalidValue for
// arguments it does not take).
// The spread adds into `acc`, which the caller zeroes, then writes every
// point of `mesh`.
extern "C" int pme_spread_launch(int dtype64, int n_rep, int n, int kx,
                                 int ky, int kz, const void* x,
                                 const void* q, const void* box, void* acc,
                                 void* mesh, void* stream) {
  if (bad(n_rep, n, kx, ky, kz)) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + APB - 1) / APB, n_rep);
  const size_t size = (size_t)n_rep * kx * ky * kz;
  const int blocks = (int)((size + CONVERT_THREADS - 1) / CONVERT_THREADS);
  const cudaStream_t s = (cudaStream_t)stream;
  auto* a = (unsigned long long*)acc;
  if (n > 0) {
    if (dtype64)
      pme_spread_kernel<double><<<grid, THREADS, 0, s>>>(
          n, kx, ky, kz, (const double*)x, (const double*)q,
          (const double*)box, a);
    else
      pme_spread_kernel<float><<<grid, THREADS, 0, s>>>(
          n, kx, ky, kz, (const float*)x, (const float*)q,
          (const float*)box, a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (dtype64)
    pme_convert_kernel<double><<<blocks, CONVERT_THREADS, 0, s>>>(
        size, a, (double*)mesh);
  else
    pme_convert_kernel<float><<<blocks, CONVERT_THREADS, 0, s>>>(
        size, a, (float*)mesh);
  return (int)cudaGetLastError();
}

// The gather writes every row of gx [n, 3] and gq [n] from phi, the mesh
// potential already scaled by 2 alpha.
extern "C" int pme_gather_launch(int dtype64, int n_rep, int n, int kx,
                                 int ky, int kz, const void* x,
                                 const void* q, const void* box,
                                 const void* phi, void* gx, void* gq,
                                 void* stream) {
  if (bad(n_rep, n, kx, ky, kz)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const dim3 grid((n + APB - 1) / APB, n_rep);
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype64)
    pme_gather_kernel<double><<<grid, THREADS, 0, s>>>(
        n, kx, ky, kz, (const double*)x, (const double*)q,
        (const double*)box, (const double*)phi, (double*)gx, (double*)gq);
  else
    pme_gather_kernel<float><<<grid, THREADS, 0, s>>>(
        n, kx, ky, kz, (const float*)x, (const float*)q, (const float*)box,
        (const float*)phi, (float*)gx, (float*)gq);
  return (int)cudaGetLastError();
}
