// K3: in-place single-token append into the dense KV cache.
//
// Replaces vats_tpu/ops/cache_append.py:_append_kernel (entry
// append_token_inplace).  The dense cache keeps the JAX package's
// sequence-minor layout k, v: [L, B, G, D, S]; one decode step writes each
// row's new K/V column at position min(length, S-1) of layer `layer`, in
// place.  `length` is read on the device (an int32 scalar tensor), so the
// step needs no host sync and a CUDA graph can capture it later.
//
// Bound: bytes.  The work is 2*B*G*D elements read and written once (64 KiB
// at the medium tier, B=16); the launch itself dominates.  One thread per
// element, no shared memory.

#include "common.cuh"

namespace {

template <typename T>
__global__ void append_kernel(T* __restrict__ k, T* __restrict__ v,
                              const T* __restrict__ k_new,
                              const T* __restrict__ v_new,
                              const int* __restrict__ length, int layer,
                              int rows, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // (b, g, d) flattened
  if (i >= rows) return;
  int pos = length[0];
  pos = pos < S - 1 ? pos : S - 1;
  pos = pos > 0 ? pos : 0;
  const size_t dst = ((size_t)layer * rows + i) * (size_t)S + pos;
  k[dst] = k_new[i];
  v[dst] = v_new[i];
}

// The yardstick for K3's fixed cost: a kernel with K3's grid and block that
// does nothing.  Not on any path; chip_smoke.py times it beside K3.
__global__ void empty_kernel(int rows) {}

template <typename T>
int launch(void* k, void* v, const void* k_new, const void* v_new,
           const void* length, int layer, int B, int G, int D, int S,
           void* stream) {
  const int rows = B * G * D;
  const int threads = 256;
  const int blocks = (rows + threads - 1) / threads;
  append_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (T*)k, (T*)v, (const T*)k_new, (const T*)v_new, (const int*)length,
      layer, rows, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vats_cache_append_bf16(void* k, void* v, const void* k_new,
                                      const void* v_new, const void* length,
                                      int layer, int B, int G, int D, int S,
                                      void* stream) {
  return launch<__nv_bfloat16>(k, v, k_new, v_new, length, layer, B, G, D, S,
                               stream);
}

extern "C" int vats_cache_append_f32(void* k, void* v, const void* k_new,
                                     const void* v_new, const void* length,
                                     int layer, int B, int G, int D, int S,
                                     void* stream) {
  return launch<float>(k, v, k_new, v_new, length, layer, B, G, D, S, stream);
}

extern "C" int vats_cache_append_empty(int B, int G, int D, void* stream) {
  const int rows = B * G * D;
  const int threads = 256;
  empty_kernel<<<(rows + threads - 1) / threads, threads, 0,
                 (cudaStream_t)stream>>>(rows);
  return (int)cudaGetLastError();
}
