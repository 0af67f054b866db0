// EmbeddingBag: for each bag b, the sum (or mean) of the table rows its ids
// name, out[b] = sum_l table[bags[b, l]] over the ids >= 0; mean divides by
// max(count of valid ids, 1).  An all-pad bag is 0 in both modes.
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag/kernel.py:
// embedding_bag_pallas (body _kernel).
//
// What bounds it on an H100: bytes.  Every valid id gathers one scattered
// d-float row (256 bytes at d = 64) for d adds -- 0.25 operations per byte --
// so the row gathers are the whole cost; the table (256 MB for dlrm-rm2's
// 1M x 64) is far larger than the 50 MB L2, so rows come from HBM.
//
// Design:
//  * a thread per (bag, column group) of VEC floats: VEC = 4 (float4) when
//    d % 4 == 0, else 1.  A bag's threads are adjacent lanes, so each
//    gathered row is read as coalesced loads (one 256-byte segment per row
//    at d = 64, 16 lanes a row with float4).  float4 issues four times
//    fewer id reads and load instructions than the scalar instantiation
//    and is the faster at dlrm-rm2's width (tools/time_embedding_bag_vec.py
//    times the two; PERF.md records the reading);
//  * the TPU kernel's scalar prefetch of the ids has no counterpart: each
//    thread reads its bag's ids (the bag's lanes read the same word, one
//    broadcast transaction);
//  * the Pallas kernel runs ``out += where(valid, row, 0)`` over its
//    sequential l axis from a zero block: here each component is one
//    __fadd_rn chain in l order from 0, adding 0 for a pad id, so the kernel
//    equals the plain version and Pallas interpret mode bit for bit; the
//    mean is one __fdiv_rn by max(count, 1).  No fast math;
//  * ids outside [0, V) are pad ids: the card never reads out of the table.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ float4 zero_of(float4) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float4 add_rn(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ float4 div_rn(float4 a, float b) {
  return make_float4(__fdiv_rn(a.x, b), __fdiv_rn(a.y, b), __fdiv_rn(a.z, b),
                     __fdiv_rn(a.w, b));
}

// T = float4 or float; dv = d / (floats in T).
template <typename T, bool MEAN>
__global__ void __launch_bounds__(THREADS) bag_kernel(
    const int* __restrict__ bags, const T* __restrict__ table, int B, int L,
    int V, int dv, T* __restrict__ out) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= (long long)B * dv) return;
  const int b = (int)(t / dv);
  const int c = (int)(t % dv);
  const int* ids = bags + (size_t)b * L;
  const T zero = zero_of(T());
  T acc = zero;
  float cnt = 0.f;
#pragma unroll 4
  for (int l = 0; l < L; ++l) {
    const int id = __ldg(ids + l);
    const bool ok = id >= 0 && id < V;
    acc = add_rn(acc, ok ? __ldg(table + (size_t)id * dv + c) : zero);
    if (MEAN) cnt = __fadd_rn(cnt, ok ? 1.f : 0.f);
  }
  if (MEAN) acc = div_rn(acc, fmaxf(cnt, 1.f));
  out[t] = acc;
}

template <typename T>
void launch(const int* bags, const void* table, int B, int L, int V, int dv,
            int mean, void* out, cudaStream_t s) {
  const long long n = (long long)B * dv;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  const T* tb = static_cast<const T*>(table);
  T* o = static_cast<T*>(out);
  if (mean)
    bag_kernel<T, true><<<blocks, THREADS, 0, s>>>(bags, tb, B, L, V, dv, o);
  else
    bag_kernel<T, false><<<blocks, THREADS, 0, s>>>(bags, tb, B, L, V, dv, o);
}

}  // namespace

extern "C" {

// bags (B, L) int32, -1 padded; table (V, d) f32; out (B, d) f32.
// mean: 0 = sum, 1 = mean.  The wrapper guarantees 16-byte aligned,
// contiguous tensors.  Returns cudaGetLastError() after the launch.
int embedding_bag_launch(const void* bags, const void* table, int B, int L,
                         int V, int d, int mean, void* out, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* ib = static_cast<const int*>(bags);
  const bool vec4 = (d & 3) == 0;
  if (vec4)
    launch<float4>(ib, table, B, L, V, d >> 2, mean, out, s);
  else
    launch<float>(ib, table, B, L, V, d, mean, out, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
