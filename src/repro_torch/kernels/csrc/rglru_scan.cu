// RG-LRU diagonal linear recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `rglru_scan_pallas` (body `_rglru_kernel`) of
// src/repro/kernels/rglru_scan.py and computes what it computes:
//   h_t = a_t * h_{t-1} + b_t   per (batch row, channel), from h_{-1} = 0,
// in f32 (a and b are read in their dtype and widened), every h_t stored in
// f32 into a contiguous [B, S, W] output. Every product and every sum is
// rounded on its own (no fused multiply-add), in the association of the
// plain version `ref.rglru_chunked_ref(a, b, T)`, so the two agree bit for
// bit on the card; against the step-by-step `ref.rglru_ref` they differ by
// the carry's rounding (below 1e-5 on the checks' inputs).
//
// Design. Channels are independent; the sequence is split into chunks of T
// steps so that the card fills: one thread owns one (batch row, chunk,
// channel), 64 neighbouring channels a block, so each step's loads of a_t,
// b_t and store of h_t are coalesced. Two kernels on one stream, one call:
//   1. rglru_aggregate_kernel, for every chunk but the last: the product of
//      its a and its h at the chunk's end from h = 0, into a scratch
//      [B, n_chunks, 2, W] f32 that the wrapper allocates;
//   2. rglru_chunk_kernel: the carry into the chunk, folded in order from the
//      preceding chunks' aggregates (carry = prod_a * carry + h_end: a few KB
//      from L2, and no block waits on another), then the chunk walked again
//      from that carry, every h_t written.
// The TPU kernel's sequential sequence axis, with its state in VMEM scratch
// carried across sequence blocks, becomes the fold. In both kernels the
// loads do not depend on h: they are issued U steps ahead (the next U steps
// are loaded into registers while the current U are computed). Inputs are
// read through their strides; any S and any W work (steps past S and
// channels past W are masked, where the Pallas wrapper needs block sizes
// that divide S and W).
//
// What bounds it. At the serving shape [4, 4096, 2560] in f32 the function
// moves 3 x 167.8 MB (a and b read once, h written once) and does 2 flops an
// element, so the card's bound is bytes: 0.150 ms at 3.35 TB/s. The first
// port ran one thread a channel, 10,240 threads, too few loads in flight to
// reach the memory rate. With T = 256 this design runs 16 times as many
// threads; it reads a and b twice (the aggregate pass and the walk), so its
// own floor is 5 x 167.8 MB, 0.25 ms. A single pass with decoupled look-back
// would read them once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;  // channels per block
constexpr int U = 16;        // steps loaded ahead of the recurrence

struct Args {
  const void* a;
  const void* b;
  float* h;
  float* agg;  // [batch, n_chunks, 2, w]: product of a, h at the chunk's end
  int s, w, t, n_chunks;
  int64_t a_sb, a_ss, a_sw;
  int64_t b_sb, b_ss, b_sw;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// steps t0 .. t0 + U - 1 of one channel, 0 at or past t_end
template <typename T>
__device__ __forceinline__ void load(const T* a, const T* b, int64_t a_ss, int64_t b_ss,
                                     int t0, int t_end, float (&av)[U], float (&bv)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 + u;
    av[u] = t < t_end ? to_f32(a[t * a_ss]) : 0.f;
    bv[u] = t < t_end ? to_f32(b[t * b_ss]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) rglru_aggregate_kernel(const Args g) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const int k = blockIdx.y;
  const int row = blockIdx.z;
  if (c >= g.w) return;
  const T* a = static_cast<const T*>(g.a) + row * g.a_sb + c * g.a_sw;
  const T* b = static_cast<const T*>(g.b) + row * g.b_sb + c * g.b_sw;
  const int t0 = k * g.t, t_end = min(t0 + g.t, g.s);

  float ca[U], cb[U], na[U], nb[U];
  load(a, b, g.a_ss, g.b_ss, t0, t_end, ca, cb);
  float prod = 1.f, h = 0.f;
  for (int tb = t0; tb < t_end; tb += U) {
    load(a, b, g.a_ss, g.b_ss, tb + U, t_end, na, nb);  // the next U steps, in flight
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (tb + u < t_end) {
        prod = __fmul_rn(prod, ca[u]);
        h = __fadd_rn(__fmul_rn(ca[u], h), cb[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
  float* out = g.agg + (int64_t(row) * g.n_chunks + k) * 2 * g.w + c;
  out[0] = prod;
  out[g.w] = h;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) rglru_chunk_kernel(const Args g) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const int k = blockIdx.y;
  const int row = blockIdx.z;
  if (c >= g.w) return;
  const T* a = static_cast<const T*>(g.a) + row * g.a_sb + c * g.a_sw;
  const T* b = static_cast<const T*>(g.b) + row * g.b_sb + c * g.b_sw;
  float* h_out = g.h + (int64_t(row) * g.s) * g.w + c;
  const int t0 = k * g.t, t_end = min(t0 + g.t, g.s);

  float ca[U], cb[U], na[U], nb[U];
  load(a, b, g.a_ss, g.b_ss, t0, t_end, ca, cb);  // in flight during the fold
  // the carry into chunk k, from the aggregates of chunks 0 .. k-1 in order
  const float* agg = g.agg + int64_t(row) * g.n_chunks * 2 * g.w + c;
  float h = 0.f;
#pragma unroll 8
  for (int j = 0; j < k; ++j)
    h = __fadd_rn(__fmul_rn(agg[2 * j * g.w], h), agg[(2 * j + 1) * g.w]);

  for (int tb = t0; tb < t_end; tb += U) {
    load(a, b, g.a_ss, g.b_ss, tb + U, t_end, na, nb);  // the next U steps, in flight
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = tb + u;
      if (t < t_end) {
        h = __fadd_rn(__fmul_rn(ca[u], h), cb[u]);
        h_out[int64_t(t) * g.w] = h;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
}

template <typename T>
cudaError_t launch(const Args& g, int batch, cudaStream_t stream) {
  const int wb = (g.w + THREADS - 1) / THREADS;
  if (g.n_chunks > 1) {  // the last chunk's aggregate is never read
    rglru_aggregate_kernel<T><<<dim3(wb, g.n_chunks - 1, batch), THREADS, 0, stream>>>(g);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  rglru_chunk_kernel<T><<<dim3(wb, g.n_chunks, batch), THREADS, 0, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of a and b: 0 = float32, 1 = bfloat16. Strides are in elements; h is
// a contiguous [batch, s, w] float32 output and agg a [batch, n_chunks, 2, w]
// float32 scratch, n_chunks = ceil(s / chunk). Launches on `stream`, on the
// caller's current device. Returns the CUDA error code of the launches.
int repro_rglru_scan_fwd(void* stream, int dtype, const void* a, const void* b, float* h,
                         float* agg, int batch, int s, int w, int chunk,
                         int64_t a_sb, int64_t a_ss, int64_t a_sw,
                         int64_t b_sb, int64_t b_ss, int64_t b_sw) {
  if (chunk < 1 || s < 1) return int(cudaErrorInvalidValue);
  const Args g{a, b, h, agg, s, w, chunk, (s + chunk - 1) / chunk,
               a_sb, a_ss, a_sw, b_sb, b_ss, b_sw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(launch<float>(g, batch, st));
    case 1: return int(launch<__nv_bfloat16>(g, batch, st));
    default: return int(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
